"""Interprocedural wire-protocol analysis: the frame registry mirror.

Counterpart of ``d4pg_tpu/lint/wiregraph.py``, reading the port's own
registry, ``d4pg_tpu_torch/core/wire.py``. Five hand-rolled wire planes (ingest 0xD4F6/0xD4F8, weights
0xD4F7/0xD4FC, updates 0xD4AB, serving 0xD4E2/0xD4E3, plus the 0xD4FA
generation greeting and the D4RS snapshot sidecar) depend on encoder
and decoder agreeing byte-for-byte. The declared truth lives in
``d4pg_tpu_torch.core.wire``; this module is the whole-program complement,
families 11-14 (the same shape as ``lockgraph`` for locks): it
independently *discovers* the protocol surface from the AST —
pack/unpack call sites, magic constants and the import chains that
carry them, flag-byte bit constants, recv-rooted decode paths — and
checks the discovery against the declaration:

- ``wire-magic-registry`` — a 0xD4xx literal or flag-bit constant
  packed into (or compared against) a frame that is absent from the
  declared table, or privately re-declared outside ``core/wire.py``.
  Seed-derivation uses (``SeedSequence(spawn_key=(0xD4E4,…))``,
  ``default_rng(seed ^ 0xD4E3)``) are exempt: those literals never
  reach a socket.
- ``codec-asymmetry`` — every pack/unpack format at a use site must be
  a contiguous field segment of a declared header/extension format of
  the magic (or plane) it serves; argument/target counts must match
  the format's field count; a ``*_SIZE``/``*_LEN`` constant shadowing a
  Struct must equal its ``calcsize``; a magic that is packed somewhere
  must be unpacked (or magic-checked) somewhere.
- ``unchecked-frame`` — a socket-facing decode (recv → ``unpack`` /
  ``np.load`` / ``np.frombuffer``) reachable without ``struct.error``/
  ``ValueError`` containment, or — where the table declares a CRC —
  without a crc32 check before payload use. This is the hostile-frame
  class a review once patched by hand; the pass keeps it closed.
- ``flag-bit-collision`` — two extensions claiming the same bit of the
  same plane's flag byte.

``python -m d4pg_tpu_torch.lint --wire`` prints the discovered registry
(magics, owning planes, pack/unpack witnesses, flag-bit map) as the
protocol review artifact; exit 1 on any finding.
"""

from __future__ import annotations

import ast
import os
import re
import struct
from dataclasses import dataclass, field

from d4pg_tpu_torch.lint.context import (
    FunctionNode, ModuleContext, dotted_name, iter_defs, last_part,
)
from d4pg_tpu_torch.lint.findings import Finding

WIRE_RULES = ("wire-magic-registry", "codec-asymmetry", "unchecked-frame",
              "flag-bit-collision")

# Static mirror of ``d4pg_tpu_torch.core.wire.REGISTRY``. Mirrored,
# not imported: the lint imports only the standard library and nothing of
# the code it analyzes. tests/test_torch_lint_clean.py pins the two tables
# equal, so they cannot drift. Rows: (name, plane, magic, header format,
# crc discipline, ((bit, meaning), ...), (extension formats, ...)).
_DECLARED = (
    ("ingest-v1", "ingest", 0xD4F6, "!II", "none", (), ()),
    ("ingest-v2", "ingest", 0xD4F8, "!II", "none",
     ((0x01, "count"), (0x02, "trace"), (0x04, "generation")),
     ("!BB", "!Qd", "!I", "!B", "!BB")),
    ("gen-greeting", "ingest", 0xD4FA, "!HI", "none", (), ()),
    ("weights-v1-req", "weights", 0xD4F7, "!Iq", "none", (), ()),
    ("weights-v1-resp", "weights", 0xD4F7, "!II", "none", (), ()),
    ("weights-v2-req", "weights", 0xD4FC, "!IqIBB", "none",
     ((0x01, "delta"),), ()),
    ("weights-v2-resp", "weights", 0xD4FC, "!IBII", "crc32-payload", (), ()),
    ("update-req", "updates", 0xD4AB, "!IIIIqqqdBII", "crc32-payload",
     (), ()),
    ("update-ack", "updates", 0xD4AB, "!IBqqdB", "none", (), ()),
    ("serve-request", "serving", 0xD4E2, "!II", "crc32-payload",
     ((0x01, "trace"),), ("!BIHHI", "!Qd")),
    ("serve-response", "serving", 0xD4E3, "!II", "crc32-payload",
     (), ("!BIIIHHI",)),
    ("sidecar", "recovery", b"D4RS", "!4sBI", "crc32-payload", (), ()),
)

_DECLARED_MAGICS = {row[2] for row in _DECLARED}
_MAGIC_PLANE = {row[2]: row[1] for row in _DECLARED}
_MAGIC_NAMES: dict = {}
for _row in _DECLARED:
    _MAGIC_NAMES.setdefault(_row[2], _row[0].rsplit("-", 1)[0])
_CRC_MAGICS = {row[2] for row in _DECLARED if row[4] != "none"}

_MAGIC_FMTS: dict = {}
_PLANE_FMTS: dict = {}
_PLANE_FLAGS: dict = {}
for _row in _DECLARED:
    _MAGIC_FMTS.setdefault(_row[2], set()).update((_row[3],) + _row[6])
    _PLANE_FMTS.setdefault(_row[1], set()).update((_row[3],) + _row[6])
    for _bit, _meaning in _row[5]:
        _PLANE_FLAGS.setdefault(_row[1], {})[_bit] = _meaning

# Calls whose argument literals are seed derivations, not wire magics.
_SEED_CALLS = {"SeedSequence", "default_rng", "PRNGKey", "fold_in",
               "Philox", "seed", "spawn"}

# Flag-bit constant shapes: F_COUNT, _F_TRACE, FLAG_TRACE, _FLAG_DELTA,
# WFLAG_DELTA, SFLAG_TRACE. Value must be a single bit of one byte.
_FLAG_NAME = re.compile(r"^_{0,2}(?:[A-Z]{0,3}FLAGS?_|F_)[A-Z0-9_]+$")
_SIZE_NAME = re.compile(r"^(?P<stem>.+?)(?:_SIZE|_LEN|_BYTES)$")

# Same spirit as lockgraph._NO_RESOLVE: method names too generic to
# resolve by bare name across the program, plus struct/socket/numpy
# methods that are codec events rather than call-graph edges.
_NO_RESOLVE = {"append", "appendleft", "extend", "popleft", "discard",
               "items", "keys", "values", "get", "setdefault", "join",
               "start", "put", "clear", "copy", "close", "set", "is_set",
               "add", "update", "remove", "insert", "count", "index",
               "sort", "wait", "pack", "unpack", "unpack_from", "calcsize",
               "load", "frombuffer", "crc32", "sendall", "send", "recv",
               "connect", "bind", "listen", "accept", "encode", "decode",
               "read", "write", "acquire", "release", "notify",
               "notify_all", "wait_for", "info", "debug", "warning",
               "error", "format", "split", "strip", "lower", "upper"}
_MAX_CANDIDATES = 12

_VALUE_CATCHES = {"ValueError", "Exception", "BaseException"}
_STRUCT_CATCHES = {"struct.error", "Exception", "BaseException"}

_MAX_DEPTH = 8

# The declaring module: the one file allowed to spell the magics.
_REGISTRY_PATH = "d4pg_tpu_torch/core/wire.py"
_REGISTRY_MODULE = "d4pg_tpu_torch.core.wire"


def _is_magic(value) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, int):
        return 0xD400 <= value <= 0xD4FF
    return (isinstance(value, bytes) and len(value) == 4
            and value.startswith(b"D4"))


def _magic_str(value) -> str:
    return f"0x{value:04X}" if isinstance(value, int) else value.decode(
        "ascii", "replace")


def _tokens(fmt: str) -> list[str]:
    """Field tokens of a struct format: ``"!IqBB"`` -> [I, q, B, B];
    ``"4s"`` stays one field; repeat counts expand."""
    body = fmt[1:] if fmt[:1] in "@=<>!" else fmt
    toks: list[str] = []
    for cnt, code in re.findall(r"(\d*)([a-zA-Z?])", body):
        if code in "sp":
            toks.append((cnt or "1") + code)
        elif code == "x":
            continue
        else:
            toks.extend([code] * int(cnt or "1"))
    return toks


def _is_segment(small: list[str], big: list[str]) -> bool:
    n = len(small)
    return n > 0 and any(big[i:i + n] == small
                         for i in range(len(big) - n + 1))


# ---------------------------------------------------------------------------
# discovery data model
# ---------------------------------------------------------------------------


@dataclass
class _Pack:
    fmt: str | None
    nargs: int | None  # None when *args present
    magics: tuple  # magic values resolved among the packed args
    line: int
    col: int
    path: str
    func: str


@dataclass
class _Unpack:
    fmt: str | None
    ntargets: int | None  # tuple-target arity, when statically visible
    buf: str | None  # buffer variable name, when it is a plain Name
    buf_literal: bool  # buffer is a bytes literal
    exact: bool  # buffer provably read with exactly calcsize(fmt) bytes
    caught: frozenset  # exception names of enclosing try blocks
    line: int
    col: int
    path: str
    func: str


@dataclass
class _Load:
    kind: str  # "np.load" | "np.frombuffer"
    buf: str | None
    caught: frozenset
    line: int
    col: int
    path: str
    func: str


@dataclass
class _WCall:
    callee: str
    recv_self: bool
    caught: frozenset
    line: int


@dataclass
class _Fn:
    key: str
    name: str
    cls: str | None
    path: str
    mod: "_Mod"
    magic_refs: set = field(default_factory=set)
    packs: list = field(default_factory=list)
    unpacks: list = field(default_factory=list)
    loads: list = field(default_factory=list)
    compares: list = field(default_factory=list)  # (magic, line)
    crc_lines: list = field(default_factory=list)
    calls: list = field(default_factory=list)
    len_checked: set = field(default_factory=set)
    recv_call: bool = False


@dataclass
class _Mod:
    path: str
    stem: str
    tree: ast.AST
    discover: bool  # sites/findings collected (False for wire.py, lint/)
    consts: dict = field(default_factory=dict)  # name -> (value, line, col)
    structs: dict = field(default_factory=dict)  # name -> (fmt, line)
    imports: dict = field(default_factory=dict)  # name -> (stem, orig)
    mod_aliases: dict = field(default_factory=dict)  # local -> module stem
    size_consts: dict = field(default_factory=dict)  # name -> (value, line, col)
    flag_consts: dict = field(default_factory=dict)  # name -> (value, line, col)
    fns: list = field(default_factory=list)


@dataclass
class _Prog:
    mods: list = field(default_factory=list)
    by_stem: dict = field(default_factory=dict)
    fns: list = field(default_factory=list)


def _is_declaration_module(path: str) -> bool:
    return path.replace(os.sep, "/").endswith(_REGISTRY_PATH)


def _is_lint_module(path: str) -> bool:
    return (os.sep + "lint" + os.sep) in path or "/lint/" in path


def _collect_env(ctx: ModuleContext) -> _Mod:
    stem = os.path.splitext(os.path.basename(ctx.path))[0]
    mod = _Mod(path=ctx.path, stem=stem, tree=ctx.tree,
               discover=not (_is_declaration_module(ctx.path)
                             or _is_lint_module(ctx.path)))
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, (int, bytes)) \
                    and not isinstance(node.value.value, bool):
                val = node.value.value
                mod.consts[name] = (val, node.lineno, node.col_offset)
                if isinstance(val, int) and _SIZE_NAME.match(name):
                    mod.size_consts[name] = (val, node.lineno,
                                             node.col_offset)
                if (isinstance(val, int) and _FLAG_NAME.match(name)
                        and 0 < val <= 0x80 and val & (val - 1) == 0):
                    mod.flag_consts[name] = (val, node.lineno,
                                             node.col_offset)
            elif isinstance(node.value, ast.Call):
                fname = dotted_name(node.value.func)
                if (fname and last_part(fname) == "Struct"
                        and node.value.args
                        and isinstance(node.value.args[0], ast.Constant)
                        and isinstance(node.value.args[0].value, str)):
                    mod.structs[name] = (node.value.args[0].value,
                                         node.lineno)
        elif isinstance(node, ast.ImportFrom) and node.module:
            src_stem = node.module.rsplit(".", 1)[-1]
            for alias in node.names:
                local = alias.asname or alias.name
                mod.imports[local] = (src_stem, alias.name)
                # ``from pkg import submodule`` makes the name a module
                # alias too; harmless when it was actually a symbol.
                mod.mod_aliases.setdefault(local, alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".", 1)[0]
                mod.mod_aliases[local] = alias.name.rsplit(".", 1)[-1]
    return mod


def _resolve_const(prog: _Prog, mod: _Mod | None, name: str,
                   depth: int = 0):
    if mod is None or depth > 4:
        return None
    if name in mod.consts:
        return mod.consts[name][0]
    if name in mod.imports:
        src_stem, orig = mod.imports[name]
        return _resolve_const(prog, prog.by_stem.get(src_stem), orig,
                              depth + 1)
    return None


def _resolve_fmt(prog: _Prog, mod: _Mod | None, name: str,
                 depth: int = 0) -> str | None:
    if mod is None or depth > 4:
        return None
    if name in mod.structs:
        return mod.structs[name][0]
    if name in mod.imports:
        src_stem, orig = mod.imports[name]
        return _resolve_fmt(prog, prog.by_stem.get(src_stem), orig,
                            depth + 1)
    return None


def _fmt_of_dotted(prog: _Prog, mod: _Mod, dotted: str) -> str | None:
    parts = dotted.split(".")
    if len(parts) == 1:
        return _resolve_fmt(prog, mod, parts[0])
    if len(parts) == 2 and parts[0] in mod.mod_aliases:
        target = prog.by_stem.get(mod.mod_aliases[parts[0]])
        if target is not None:
            return _resolve_fmt(prog, target, parts[1])
    return None


def _flag_origin(prog: _Prog, mod: _Mod, name: str,
                 depth: int = 0) -> tuple[str, str] | None:
    """(module stem, const name) where a flag constant is actually
    defined — import aliases chase back to the declaring module."""
    if mod is None or depth > 4:
        return None
    if name in mod.consts:
        return (mod.stem, name)
    if name in mod.imports:
        src_stem, orig = mod.imports[name]
        target = prog.by_stem.get(src_stem)
        if target is not None:
            return _flag_origin(prog, target, orig, depth + 1)
        return (src_stem, orig)
    return None


def _flag_base(name: str) -> str:
    base = re.sub(r"^(?:[a-z]{0,3}flags?_|f_)", "", name.lower().lstrip("_"))
    return base


def _handler_names(handlers) -> frozenset:
    names: set[str] = set()
    for h in handlers:
        if h.type is None:
            names.add("BaseException")
        elif isinstance(h.type, ast.Tuple):
            for elt in h.type.elts:
                d = dotted_name(elt)
                if d:
                    names.add(d)
        else:
            d = dotted_name(h.type)
            if d:
                names.add(d)
    return frozenset(names)


def _exempt_ids(tree: ast.AST) -> set[int]:
    """ids of Constant nodes inside seed-derivation calls."""
    out: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname and last_part(fname) in _SEED_CALLS:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Constant):
                        out.add(id(sub))
    return out


class _FnWalker:
    """One function body -> pack/unpack/load/call/crc/magic facts, with
    enclosing-try exception names tracked per site."""

    def __init__(self, fn: _Fn, mod: _Mod, prog: _Prog, exempt: set[int]):
        self.fn = fn
        self.mod = mod
        self.prog = prog
        self.exempt = exempt
        self.recv_bufs: list = []  # (name, line, size value|None)
        self._site_meta: dict[int, int] = {}  # id(call node) -> ntargets

    # -- constant / format / size resolution at a use site ---------------

    def _const_of(self, node):
        if isinstance(node, ast.Constant):
            if id(node) in self.exempt:
                return None
            v = node.value
            return v if isinstance(v, (int, bytes)) \
                and not isinstance(v, bool) else None
        if isinstance(node, ast.Name):
            return _resolve_const(self.prog, self.mod, node.id)
        if isinstance(node, ast.Attribute):
            d = dotted_name(node)
            if d:
                parts = d.split(".")
                if len(parts) == 2 and parts[0] in self.mod.mod_aliases:
                    target = self.prog.by_stem.get(
                        self.mod.mod_aliases[parts[0]])
                    if target is not None:
                        return _resolve_const(self.prog, target, parts[1])
        return None

    def _size_of(self, node):
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            return node.value
        if isinstance(node, ast.Name):
            v = _resolve_const(self.prog, self.mod, node.id)
            return v if isinstance(v, int) else None
        if isinstance(node, ast.Attribute):
            d = dotted_name(node)
            if d and d.endswith(".size"):
                fmt = _fmt_of_dotted(self.prog, self.mod, d[:-len(".size")])
                if fmt is not None:
                    try:
                        return struct.calcsize(fmt)
                    except struct.error:
                        return None
            return None
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.Add, ast.Sub, ast.Mult)):
            left = self._size_of(node.left)
            right = self._size_of(node.right)
            if left is None or right is None:
                return None
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            return left * right
        return None

    # -- statement driver -------------------------------------------------

    def walk(self, stmts, caught: frozenset = frozenset()) -> None:
        for s in stmts:
            self._stmt(s, caught)

    def _stmt(self, s, caught: frozenset) -> None:
        if isinstance(s, FunctionNode + (ast.ClassDef,)):
            return  # nested defs are separate _Fn entries
        if isinstance(s, ast.Try) or (hasattr(ast, "TryStar")
                                      and isinstance(s, ast.TryStar)):
            names = _handler_names(s.handlers)
            self.walk(s.body, caught | names)
            for h in s.handlers:
                if h.type is not None:
                    self._expr(h.type, caught)
                self.walk(h.body, caught)
            self.walk(s.orelse, caught)
            self.walk(s.finalbody, caught)
            return
        if isinstance(s, ast.Assign):
            self._assign_meta(s)
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.stmt):
                self._stmt(child, caught)
            elif not isinstance(child, (ast.expr_context, ast.operator,
                                        ast.boolop, ast.unaryop,
                                        ast.cmpop)):
                self._expr(child, caught)

    def _assign_meta(self, s: ast.Assign) -> None:
        if not isinstance(s.value, ast.Call):
            return
        fname = dotted_name(s.value.func)
        callee = last_part(fname) if fname else getattr(
            s.value.func, "attr", None)
        if callee is None:
            return
        if "recv" in callee and len(s.targets) == 1 \
                and isinstance(s.targets[0], ast.Name):
            args = s.value.args
            if callee == "recv":
                size_node = args[0] if args else None
            else:
                size_node = args[1] if len(args) >= 2 else (
                    args[0] if args else None)
            size = self._size_of(size_node) if size_node is not None \
                else None
            self.recv_bufs.append((s.targets[0].id, s.lineno, size))
        if callee in ("unpack", "unpack_from") and len(s.targets) == 1:
            tgt = s.targets[0]
            if isinstance(tgt, ast.Tuple) and not any(
                    isinstance(e, ast.Starred) for e in tgt.elts):
                self._site_meta[id(s.value)] = len(tgt.elts)

    # -- expression visitor -----------------------------------------------

    def _expr(self, node, caught: frozenset) -> None:
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                self._call(n, caught)
            elif isinstance(n, ast.Compare):
                self._compare(n)
            elif isinstance(n, (ast.Name, ast.Attribute)):
                v = self._const_of(n)
                if v is not None and _is_magic(v):
                    self.fn.magic_refs.add(v)

    def _compare(self, n: ast.Compare) -> None:
        for comp in [n.left] + list(n.comparators):
            elts = comp.elts if isinstance(comp, ast.Tuple) else [comp]
            for elt in elts:
                v = self._const_of(elt)
                if v is not None and _is_magic(v):
                    self.fn.compares.append((v, elt.lineno))
                    self.fn.magic_refs.add(v)

    def _buf_facts(self, buf_node, fmt: str | None):
        """(name, is_literal, exact) for an unpack buffer argument."""
        name = buf_node.id if isinstance(buf_node, ast.Name) else None
        literal = isinstance(buf_node, ast.Constant) and isinstance(
            getattr(buf_node, "value", None), bytes)
        exact = False
        if name is not None and fmt is not None:
            try:
                want = struct.calcsize(fmt)
            except struct.error:
                want = None
            got = None
            for bname, bline, bsize in self.recv_bufs:
                if bname == name and bline <= buf_node.lineno:
                    got = bsize  # latest assignment before the site wins
            if want is not None and got is not None and got == want:
                exact = True
        return name, literal, exact

    def _call(self, n: ast.Call, caught: frozenset) -> None:
        fname = dotted_name(n.func)
        callee = last_part(fname) if fname else getattr(
            n.func, "attr", None)
        if callee is None:
            return
        prefix = fname.rsplit(".", 1)[0] if fname and "." in fname else None

        if "recv" in callee:
            self.fn.recv_call = True

        if callee == "crc32":
            self.fn.crc_lines.append(n.lineno)

        if callee == "pack":
            if prefix == "struct" or (
                    prefix and self.mod.mod_aliases.get(prefix) == "struct"):
                fmt = (n.args[0].value
                       if n.args and isinstance(n.args[0], ast.Constant)
                       and isinstance(n.args[0].value, str) else None)
                payload_args = n.args[1:]
            else:
                fmt = _fmt_of_dotted(self.prog, self.mod, prefix) \
                    if prefix else None
                payload_args = n.args
            starred = any(isinstance(a, ast.Starred) for a in payload_args)
            magics = []
            for a in payload_args:
                v = self._const_of(a)
                if v is not None and _is_magic(v):
                    magics.append(v)
                    self.fn.magic_refs.add(v)
            self.fn.packs.append(_Pack(
                fmt=fmt, nargs=None if starred else len(payload_args),
                magics=tuple(magics), line=n.lineno, col=n.col_offset,
                path=self.fn.path, func=self.fn.key))
            return

        if callee in ("unpack", "unpack_from"):
            if prefix == "struct" or (
                    prefix and self.mod.mod_aliases.get(prefix) == "struct"):
                fmt = (n.args[0].value
                       if n.args and isinstance(n.args[0], ast.Constant)
                       and isinstance(n.args[0].value, str) else None)
                buf_node = n.args[1] if len(n.args) >= 2 else None
            else:
                fmt = _fmt_of_dotted(self.prog, self.mod, prefix) \
                    if prefix else None
                buf_node = n.args[0] if n.args else None
            name, literal, exact = (None, False, False)
            if buf_node is not None:
                name, literal, exact = self._buf_facts(buf_node, fmt)
            self.fn.unpacks.append(_Unpack(
                fmt=fmt, ntargets=self._site_meta.get(id(n)), buf=name,
                buf_literal=literal, exact=exact, caught=caught,
                line=n.lineno, col=n.col_offset, path=self.fn.path,
                func=self.fn.key))
            return

        if callee == "load" and prefix in ("np", "numpy"):
            self.fn.loads.append(_Load(
                kind="np.load", buf=None, caught=caught, line=n.lineno,
                col=n.col_offset, path=self.fn.path, func=self.fn.key))
            return

        if callee == "frombuffer" and prefix in ("np", "numpy"):
            buf = n.args[0] if n.args else None
            if isinstance(buf, ast.Name):
                self.fn.loads.append(_Load(
                    kind="np.frombuffer", buf=buf.id, caught=caught,
                    line=n.lineno, col=n.col_offset, path=self.fn.path,
                    func=self.fn.key))
            return

        if callee == "len" and n.args and isinstance(n.args[0], ast.Name):
            self.fn.len_checked.add(n.args[0].id)
            return

        if callee in _NO_RESOLVE or callee.startswith("__"):
            return
        recv_self = bool(fname) and fname.startswith("self.") \
            and fname.count(".") == 1
        self.fn.calls.append(_WCall(callee=callee, recv_self=recv_self,
                                    caught=caught, line=n.lineno))


# ---------------------------------------------------------------------------
# program build + call resolution (lockgraph's shape)
# ---------------------------------------------------------------------------


def _build_program(ctxs: list[ModuleContext]) -> _Prog:
    prog = _Prog()
    for ctx in ctxs:
        prog.mods.append(_collect_env(ctx))
    for mod in prog.mods:
        # first module wins a stem; ambiguous stems (``__init__``) are
        # never import targets in practice
        prog.by_stem.setdefault(mod.stem, mod)
    for mod in prog.mods:
        if not mod.discover:
            continue
        exempt = _exempt_ids(mod.tree)
        for node, qual, cls in iter_defs(mod.tree):
            fn = _Fn(key=f"{mod.path}::{qual}", name=node.name, cls=cls,
                     path=mod.path, mod=mod)
            _FnWalker(fn, mod, prog, exempt).walk(node.body)
            mod.fns.append(fn)
        mod_stmts = [s for s in mod.tree.body
                     if not isinstance(s, FunctionNode + (ast.ClassDef,))]
        if mod_stmts:
            fn = _Fn(key=f"{mod.path}::<module>", name="<module>",
                     cls=None, path=mod.path, mod=mod)
            _FnWalker(fn, mod, prog, exempt).walk(mod_stmts)
            mod.fns.append(fn)
        prog.fns.extend(mod.fns)
    return prog


def _resolve_call(call: _WCall, caller: _Fn,
                  by_name: dict, by_class: dict) -> list:
    if call.recv_self and caller.cls is not None:
        own = by_class.get((caller.cls, call.callee))
        if own:
            return own
    cands = [f for f in by_name.get(call.callee, ())
             if not (call.recv_self is False and caller.cls is not None
                     and f.cls == caller.cls and f.path == caller.path)]
    if len(cands) > _MAX_CANDIDATES:
        return []
    return cands


# ---------------------------------------------------------------------------
# graph + analysis
# ---------------------------------------------------------------------------


@dataclass
class WireGraph:
    functions: int = 0
    modules: int = 0
    # magic value -> {"plane", "name", "packs": [wit], "unpacks": [wit]}
    magics: dict = field(default_factory=dict)
    # plane -> {bit: meaning}
    flags: dict = field(default_factory=dict)
    findings: list = field(default_factory=list)


def _short(key: str) -> str:
    path, _, qual = key.partition("::")
    return f"{os.path.basename(path)}::{qual}"


def _witness(path: str, line: int, func: str) -> str:
    return f"{path}:{line} ({func.partition('::')[2]})"


def _module_planes(mod: _Mod) -> set:
    planes = set()
    for name, (value, _l, _c) in mod.consts.items():
        if _is_magic(value) and value in _MAGIC_PLANE:
            planes.add(_MAGIC_PLANE[value])
    for fn in mod.fns:
        for v in fn.magic_refs:
            if v in _MAGIC_PLANE:
                planes.add(_MAGIC_PLANE[v])
    return planes


def analyze(ctxs: list[ModuleContext],
            rules: list[str] | None = None) -> WireGraph:
    """Run the whole-program wire pass; ``rules`` filters which families
    emit findings (all families always contribute to the printed
    registry)."""
    active = set(rules) if rules is not None else set(WIRE_RULES)
    prog = _build_program(ctxs)
    graph = WireGraph(functions=len(prog.fns),
                      modules=sum(1 for m in prog.mods if m.discover))
    out: list[Finding] = []

    by_name: dict = {}
    by_class: dict = {}
    for f in prog.fns:
        by_name.setdefault(f.name, []).append(f)
        by_class.setdefault((f.cls, f.name), []).append(f)
    resolved = {f.key: [(c, _resolve_call(c, f, by_name, by_class))
                        for c in f.calls] for f in prog.fns}

    _discover_registry(prog, resolved, graph)
    _check_magic_registry(prog, graph, out)
    _check_codec(prog, graph, out)
    _check_flags(prog, graph, out)
    _check_unchecked(prog, resolved, out)

    graph.findings = sorted(
        (f for f in out if f.rule in active),
        key=lambda f: (f.file, f.line, f.col, f.rule))
    return graph


def _reach(fn: _Fn, resolved: dict, depth: int = 3) -> list:
    """Functions reachable from ``fn`` within ``depth`` calls (incl. fn)."""
    seen = {fn.key}
    frontier, out = [fn], [fn]
    for _ in range(depth):
        nxt = []
        for f in frontier:
            for _call, cands in resolved[f.key]:
                for g in cands:
                    if g.key not in seen:
                        seen.add(g.key)
                        nxt.append(g)
                        out.append(g)
        frontier = nxt
    return out


def _discover_registry(prog: _Prog, resolved: dict,
                       graph: WireGraph) -> None:
    """The printed surface: per magic, where it is packed and where it
    is unpacked/checked. Attribution: a pack carrying the magic as an
    argument is direct; otherwise every pack/unpack/compare site within
    a short call radius of a function that references the magic counts
    as a witness for it."""

    def entry(m):
        return graph.magics.setdefault(m, {
            "plane": _MAGIC_PLANE.get(m),
            "name": _MAGIC_NAMES.get(m),
            "packs": [], "unpacks": []})

    def add(lst, wit):
        if wit not in lst and len(lst) < 6:
            lst.append(wit)

    for fn in prog.fns:
        for p in fn.packs:
            for m in p.magics:
                add(entry(m)["packs"], _witness(p.path, p.line, p.func))
        for m, line in fn.compares:
            add(entry(m)["unpacks"], _witness(fn.path, line, fn.key))

    for fn in prog.fns:
        if not fn.magic_refs:
            continue
        nearby = _reach(fn, resolved)
        for m in fn.magic_refs:
            e = entry(m)
            for g in nearby:
                for p in g.packs:
                    if not p.magics:
                        add(e["packs"], _witness(p.path, p.line, p.func))
                for u in g.unpacks:
                    add(e["unpacks"], _witness(u.path, u.line, u.func))

    for plane, bits in _PLANE_FLAGS.items():
        graph.flags[plane] = dict(bits)


def _check_magic_registry(prog: _Prog, graph: WireGraph,
                          out: list) -> None:
    used: set = set()  # magic values reaching a pack/compare anywhere
    for fn in prog.fns:
        for p in fn.packs:
            used.update(p.magics)
        for m, _line in fn.compares:
            used.add(m)

    for fn in prog.fns:
        for p in fn.packs:
            for m in p.magics:
                if m not in _DECLARED_MAGICS:
                    out.append(Finding(
                        file=fn.path, line=p.line, col=p.col,
                        rule="wire-magic-registry",
                        message=(
                            f"magic {_magic_str(m)} is packed into a frame "
                            f"but is absent from the declared registry "
                            f"({_REGISTRY_PATH})")))
        for m, line in fn.compares:
            if m not in _DECLARED_MAGICS:
                out.append(Finding(
                    file=fn.path, line=line, col=0,
                    rule="wire-magic-registry",
                    message=(
                        f"magic {_magic_str(m)} is checked on a frame "
                        f"but is absent from the declared registry "
                        f"({_REGISTRY_PATH})")))

    for mod in prog.mods:
        if not mod.discover:
            continue
        for name, (value, line, col) in mod.consts.items():
            if _is_magic(value) and value in _DECLARED_MAGICS \
                    and value in used:
                out.append(Finding(
                    file=mod.path, line=line, col=col,
                    rule="wire-magic-registry",
                    message=(
                        f"{name} re-declares wire magic "
                        f"{_magic_str(value)} (plane "
                        f"{_MAGIC_PLANE[value]}) privately; import it "
                        f"from {_REGISTRY_MODULE}")))


def _check_codec(prog: _Prog, graph: WireGraph, out: list) -> None:
    for mod in prog.mods:
        if not mod.discover:
            continue
        planes = _module_planes(mod)

        # header-length constant vs calcsize of the sibling Struct
        for name, (value, line, col) in mod.size_consts.items():
            stem = _SIZE_NAME.match(name).group("stem")
            if stem in mod.structs:
                fmt = mod.structs[stem][0]
                try:
                    want = struct.calcsize(fmt)
                except struct.error:
                    continue
                if want != value:
                    out.append(Finding(
                        file=mod.path, line=line, col=col,
                        rule="codec-asymmetry",
                        message=(
                            f"{name} = {value} disagrees with "
                            f"calcsize({fmt!r}) = {want} of {stem}")))

        for fn in mod.fns:
            declared_refs = {m for m in fn.magic_refs
                             if m in _DECLARED_MAGICS}
            if declared_refs:
                allowed = set()
                for m in declared_refs:
                    allowed |= _MAGIC_FMTS[m]
            elif len(planes) >= 1:
                allowed = set()
                for p in planes:
                    allowed |= _PLANE_FMTS[p]
            else:
                allowed = None  # no wire context: not a codec site

            for site in fn.packs + fn.unpacks:
                if site.fmt is None:
                    continue
                toks = _tokens(site.fmt)
                if allowed is not None and not any(
                        _is_segment(toks, _tokens(a)) for a in allowed):
                    kind = "pack" if isinstance(site, _Pack) else "unpack"
                    out.append(Finding(
                        file=mod.path, line=site.line, col=site.col,
                        rule="codec-asymmetry",
                        message=(
                            f"{kind} format {site.fmt!r} is not a field "
                            f"segment of any declared header/extension "
                            f"format for its magic/plane "
                            f"({', '.join(sorted(allowed))})")))
                    continue
                if isinstance(site, _Pack) and site.nargs is not None \
                        and site.nargs != len(toks):
                    out.append(Finding(
                        file=mod.path, line=site.line, col=site.col,
                        rule="codec-asymmetry",
                        message=(
                            f"pack format {site.fmt!r} declares "
                            f"{len(toks)} field(s) but {site.nargs} "
                            f"argument(s) are packed")))
                if isinstance(site, _Unpack) and site.ntargets is not None \
                        and site.ntargets != len(toks):
                    out.append(Finding(
                        file=mod.path, line=site.line, col=site.col,
                        rule="codec-asymmetry",
                        message=(
                            f"unpack format {site.fmt!r} yields "
                            f"{len(toks)} field(s) but {site.ntargets} "
                            f"target(s) are bound")))

    # one-sided codec: a declared magic packed somewhere must be
    # unpacked or magic-checked somewhere in the program
    for m, e in graph.magics.items():
        if m in _DECLARED_MAGICS and e["packs"] and not e["unpacks"]:
            path, _, rest = e["packs"][0].partition(":")
            line = int(rest.split(" ")[0])
            out.append(Finding(
                file=path, line=line, col=0, rule="codec-asymmetry",
                message=(
                    f"magic {_magic_str(m)} is packed but never "
                    f"unpacked or checked anywhere in the program "
                    f"(one-sided codec)")))


def _check_flags(prog: _Prog, graph: WireGraph, out: list) -> None:
    # plane -> bit -> list of (base meaning, origin, path, line, col, name)
    claims: dict = {}
    for plane, bits in _PLANE_FLAGS.items():
        for bit, meaning in bits.items():
            claims.setdefault(plane, {}).setdefault(bit, []).append(
                (meaning, ("registry", meaning), None, 0, 0, "registry"))

    for mod in prog.mods:
        if not mod.discover:
            continue
        planes = _module_planes(mod)
        if len(planes) != 1:
            continue  # no unambiguous flag-byte namespace
        plane = next(iter(planes))
        declared_bits = _PLANE_FLAGS.get(plane, {})
        for name, (value, line, col) in mod.flag_consts.items():
            origin = _flag_origin(prog, mod, name) or (mod.stem, name)
            if origin[0] == "wire":
                continue  # the declaration itself, via import
            base = _flag_base(name)
            if value in declared_bits:
                meaning = declared_bits[value]
                if base in meaning or meaning in base:
                    continue  # consistent local mirror of a declared bit
                out.append(Finding(
                    file=mod.path, line=line, col=col,
                    rule="flag-bit-collision",
                    message=(
                        f"{name} claims bit {value:#04x} of the "
                        f"{plane} flag byte, already allocated to "
                        f"'{meaning}' in the declared registry")))
            else:
                prior = claims.get(plane, {}).get(value, [])
                local_prior = [c for c in prior if c[1] != origin
                               and _flag_base(c[5]) != base]
                if local_prior:
                    out.append(Finding(
                        file=mod.path, line=line, col=col,
                        rule="flag-bit-collision",
                        message=(
                            f"{name} claims bit {value:#04x} of the "
                            f"{plane} flag byte, already claimed by "
                            f"{local_prior[0][5]}")))
                else:
                    out.append(Finding(
                        file=mod.path, line=line, col=col,
                        rule="wire-magic-registry",
                        message=(
                            f"{name} allocates flag bit {value:#04x} of "
                            f"the {plane} flag byte outside the declared "
                            f"registry ({_REGISTRY_PATH})")))
            claims.setdefault(plane, {}).setdefault(value, []).append(
                (base, origin, mod.path, line, col, name))
            graph.flags.setdefault(plane, {}).setdefault(value, base)


def _check_unchecked(prog: _Prog, resolved: dict, out: list) -> None:
    # socket-facing closure: calls recv, or calls something that does
    facing = {f.key for f in prog.fns if f.recv_call}
    changed = True
    while changed:
        changed = False
        for f in prog.fns:
            if f.key in facing:
                continue
            if any(g.key in facing
                   for _c, cands in resolved[f.key] for g in cands):
                facing.add(f.key)
                changed = True

    by_key = {f.key: f for f in prog.fns}
    reported: set = set()
    seen: set = set()

    def report(site, reason: str) -> None:
        key = (site.path, site.line, reason)
        if key in reported:
            return
        reported.add(key)
        out.append(Finding(
            file=site.path, line=site.line, col=site.col,
            rule="unchecked-frame", message=reason))

    def crc_before(fn: _Fn, line: int) -> bool:
        return any(c < line for c in fn.crc_lines)

    def visit(fn: _Fn, has_struct: bool, has_value: bool,
              crc_ok: bool, crc_req: bool, depth: int) -> None:
        crc_req = crc_req or any(m in _CRC_MAGICS for m in fn.magic_refs)
        sig = (fn.key, has_struct, has_value, crc_ok, crc_req)
        if sig in seen or depth > _MAX_DEPTH:
            return
        seen.add(sig)

        for u in fn.unpacks:
            if u.exact or u.buf_literal:
                continue
            if u.buf is not None and u.buf in fn.len_checked:
                continue
            if has_struct or u.caught & _STRUCT_CATCHES:
                continue
            report(u, (
                "socket-facing unpack of an unverified buffer without "
                "struct.error containment on the recv path"))

        for ld in fn.loads:
            contained = has_value or bool(ld.caught & _VALUE_CATCHES)
            site_crc = crc_ok or crc_before(fn, ld.line)
            if ld.kind == "np.load":
                if not contained:
                    report(ld, (
                        "socket-facing np.load of a received payload "
                        "without ValueError containment on the recv "
                        "path (hostile frame kills the thread)"))
                if crc_req and not site_crc:
                    report(ld, (
                        "payload parsed before any crc32 check on a "
                        "plane whose registry entry declares "
                        "crc32-payload"))
            else:  # np.frombuffer on a named buffer
                if ld.buf not in fn.len_checked and not contained:
                    report(ld, (
                        "socket-facing np.frombuffer of an unverified "
                        "buffer without ValueError containment on the "
                        "recv path"))
                if crc_req and not site_crc:
                    report(ld, (
                        "payload parsed before any crc32 check on a "
                        "plane whose registry entry declares "
                        "crc32-payload"))

        for call, cands in resolved[fn.key]:
            if not cands:
                continue
            n_struct = has_struct or bool(call.caught & _STRUCT_CATCHES)
            n_value = has_value or bool(call.caught & _VALUE_CATCHES)
            n_crc = crc_ok or crc_before(fn, call.line)
            for g in cands:
                visit(g, n_struct, n_value, n_crc, crc_req, depth + 1)

    for key in sorted(facing):
        fn = by_key[key]
        visit(fn, False, False, False, False, 0)


def format_registry(graph: WireGraph) -> str:
    """Human-readable artifact for ``--wire``, mirroring the ``--locks``
    lock-graph printout."""
    n_pack = sum(len(e["packs"]) for e in graph.magics.values())
    n_unpack = sum(len(e["unpacks"]) for e in graph.magics.values())
    lines = [
        f"wire registry: {len(graph.magics)} magic(s), "
        f"{n_pack} pack witness(es), {n_unpack} unpack witness(es) over "
        f"{graph.functions} function(s) in {graph.modules} module(s)",
        "magics:",
    ]

    def sort_key(item):
        m = item[0]
        return (0, m, "") if isinstance(m, int) else (1, 0, m)

    for m, e in sorted(graph.magics.items(), key=sort_key):
        plane = e["plane"] or "UNREGISTERED"
        name = e["name"] or "?"
        lines.append(f"  {_magic_str(m)}  {plane:<9} {name}")
        for kind in ("packs", "unpacks"):
            wits = e[kind]
            label = kind[:-1]
            if not wits:
                lines.append(f"    {label}: none")
            else:
                first = wits[0]
                more = f" [+{len(wits) - 1} more]" if len(wits) > 1 else ""
                lines.append(f"    {label}: {first}{more}")
    lines.append("flag bits:")
    for plane in sorted(graph.flags):
        bits = graph.flags[plane]
        cols = "  ".join(
            f"bit{bit.bit_length() - 1}={meaning}"
            for bit, meaning in sorted(bits.items()))
        lines.append(f"  {plane:<9} {cols}")
    if graph.findings:
        lines.append(f"findings: {len(graph.findings)}")
        for f in graph.findings:
            lines.append(f"  {f.format()}")
    else:
        lines.append("findings: none")
    return "\n".join(lines)
