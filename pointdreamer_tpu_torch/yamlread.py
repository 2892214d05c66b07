"""A YAML reader that loads what PyYAML 6.0's `yaml.safe_load` loads, for
one document, and refuses what it refuses.

The port reads its configs without PyYAML, and a config file may hold any
YAML that `yaml.safe_load` reads (the JAX package loads configs with it).
This follows PyYAML's pipeline step by step: a scanner with its simple-key
and indentation rules (block and flow collections, plain, quoted, literal
and folded scalars, anchors, aliases, tags, `? ` keys, directives), a
parser of one document, the composer's anchors, YAML 1.1's implicit
resolution of plain scalars (null, bool, int and float in every base and
in sexagesimal, timestamps, merge keys) and the safe constructor (the
`!!str !!int !!float !!bool !!null !!binary !!timestamp !!seq !!map !!set
!!omap !!pairs` tags, `<<` merges).  Any input PyYAML refuses raises
ValueError naming the line: a tab that starts a token, a mapping value
where none is allowed, an undefined alias, a duplicate anchor, a tag with
no safe constructor, a second document.
"""
from __future__ import annotations

import base64
import binascii
import datetime
import re

_BREAKS = "\r\n\x85\u2028\u2029"
_END = "\0" + _BREAKS                    # a line break or the end
_BLANK_END = "\0 \t" + _BREAKS           # a blank, a line break or the end
_WORD = re.compile(r"[0-9A-Za-z_-]")
_URI = re.compile(r"[0-9A-Za-z\-;/?:@&=+$,_.!~*'()\[\]%]")
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF"
                            "\uE000-\uFFFD\U00010000-\U0010ffff]")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09",
            "n": "\x0A", "v": "\x0B", "f": "\x0C", "r": "\x0D", "e": "\x1B",
            " ": " ", '"': '"', "\\": "\\", "/": "/", "N": "\x85",
            "_": "\xA0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
TAG = "tag:yaml.org,2002:"


def fail(line: int, msg: str):
    raise ValueError(f"config line {line}: {msg}")


class _Token:
    __slots__ = ("kind", "value", "line", "plain")

    def __init__(self, kind, line, value=None, plain=False):
        self.kind, self.line, self.value, self.plain = kind, line, value, \
            plain


class _Key:
    """A place where a simple key may start (PyYAML's SimpleKey)."""
    __slots__ = ("token_number", "required", "index", "line", "column")

    def __init__(self, token_number, required, index, line, column):
        self.token_number, self.required = token_number, required
        self.index, self.line, self.column = index, line, column


class _Scanner:
    """PyYAML's Scanner, run to the end of the stream at once."""

    def __init__(self, text: str):
        m = _NON_PRINTABLE.search(text)
        if m:
            fail(text.count("\n", 0, m.start()) + 1,
                 f"special character {m.group()!r} is not allowed")
        self.buf = text + "\0"
        self.index = self.line = self.column = 0
        self.flow_level = 0
        self.tokens = []
        self.indent = -1
        self.indents = []
        self.allow_simple_key = True
        self.keys = {}                   # flow level -> _Key
        self.tokens.append(_Token("STREAM-START", 1))
        self.done = False
        while not self.done:
            self.fetch_more_tokens()

    # -- reading ------------------------------------------------------
    def peek(self, k=0):
        return self.buf[self.index + k] if self.index + k < len(
            self.buf) else "\0"

    def prefix(self, n):
        return self.buf[self.index:self.index + n]

    def forward(self, n=1):
        for _ in range(n):
            ch = self.buf[self.index]
            self.index += 1
            if ch in "\n\x85\u2028\u2029" or (
                    ch == "\r" and self.buf[self.index] != "\n"):
                self.line += 1
                self.column = 0
            elif ch != "\ufeff":
                self.column += 1

    def err(self, msg):
        fail(self.line + 1, msg)

    def tok(self, kind, value=None, **kw):
        return _Token(kind, self.line + 1, value, **kw)

    def line_break(self):
        ch = self.peek()
        if ch in "\r\n\x85":
            self.forward(2 if self.prefix(2) == "\r\n" else 1)
            return "\n"
        if ch in "\u2028\u2029":
            self.forward()
            return ch
        return ""

    # -- the token loop -----------------------------------------------
    def fetch_more_tokens(self):
        self.scan_to_next_token()
        self.stale_keys()
        self.unwind_indent(self.column)
        ch = self.peek()
        if ch == "\0":
            self.unwind_indent(-1)
            self.remove_key()
            self.allow_simple_key = False
            self.keys = {}
            self.tokens.append(self.tok("STREAM-END"))
            self.done = True
        elif ch == "%" and self.column == 0:
            self.unwind_indent(-1)
            self.remove_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_directive())
        elif ch in "-." and self.column == 0 and self.prefix(3) in (
                "---", "...") and self.peek(3) in _BLANK_END:
            self.unwind_indent(-1)
            self.remove_key()
            self.allow_simple_key = False
            kind = "DOC-START" if ch == "-" else "DOC-END"
            self.tokens.append(self.tok(kind))
            self.forward(3)
        elif ch in "[{":
            self.save_key()
            self.flow_level += 1
            self.allow_simple_key = True
            self.tokens.append(self.tok("FSEQ" if ch == "[" else "FMAP"))
            self.forward()
        elif ch in "]}":
            self.remove_key()
            self.flow_level -= 1
            self.allow_simple_key = False
            self.tokens.append(self.tok("FSEQ-END" if ch == "]"
                                        else "FMAP-END"))
            self.forward()
        elif ch == ",":
            self.allow_simple_key = True
            self.remove_key()
            self.tokens.append(self.tok("FENTRY"))
            self.forward()
        elif ch == "-" and self.peek(1) in _BLANK_END:
            if not self.flow_level:
                if not self.allow_simple_key:
                    self.err("sequence entries are not allowed here")
                if self.add_indent(self.column):
                    self.tokens.append(self.tok("BSEQ"))
            self.allow_simple_key = True
            self.remove_key()
            self.tokens.append(self.tok("BENTRY"))
            self.forward()
        elif ch == "?" and (self.flow_level or self.peek(1) in _BLANK_END):
            if not self.flow_level:
                if not self.allow_simple_key:
                    self.err("mapping keys are not allowed here")
                if self.add_indent(self.column):
                    self.tokens.append(self.tok("BMAP"))
            self.allow_simple_key = not self.flow_level
            self.remove_key()
            self.tokens.append(self.tok("KEY"))
            self.forward()
        elif ch == ":" and (self.flow_level or self.peek(1) in _BLANK_END):
            self.fetch_value()
        elif ch in "*&":
            self.save_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_anchor())
        elif ch == "!":
            self.save_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_tag())
        elif ch in "|>" and not self.flow_level:
            self.allow_simple_key = True
            self.remove_key()
            self.tokens.append(self.scan_block_scalar(ch == ">"))
        elif ch in "'\"":
            self.save_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_flow_scalar(ch == '"'))
        elif self.check_plain():
            self.save_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_plain())
        else:
            self.err(f"found character {ch!r} that cannot start any token")

    def check_plain(self):
        ch = self.peek()
        return ch not in "\0 \t\r\n\x85\u2028\u2029-?:,[]{}#&*!|>'\"%@`" \
            or (self.peek(1) not in _BLANK_END and (
                ch == "-" or (not self.flow_level and ch in "?:")))

    def scan_to_next_token(self):
        if self.index == 0 and self.peek() == "\ufeff":
            self.forward()
        while True:
            while self.peek() == " ":
                self.forward()
            if self.peek() == "#":
                while self.peek() not in _END:
                    self.forward()
            if self.line_break():
                if not self.flow_level:
                    self.allow_simple_key = True
            else:
                return

    # -- simple keys and indentation ------------------------------------
    def stale_keys(self):
        for level in list(self.keys):
            key = self.keys[level]
            if key.line != self.line or self.index - key.index > 1024:
                if key.required:
                    fail(key.line + 1, "could not find expected ':' after "
                         "a simple key")
                del self.keys[level]

    def save_key(self):
        required = not self.flow_level and self.indent == self.column
        if self.allow_simple_key:
            self.remove_key()
            self.keys[self.flow_level] = _Key(len(self.tokens), required,
                                              self.index, self.line,
                                              self.column)

    def remove_key(self):
        key = self.keys.pop(self.flow_level, None)
        if key is not None and key.required:
            fail(key.line + 1, "could not find expected ':' after a simple "
                 "key")

    def unwind_indent(self, column):
        if self.flow_level:
            return
        while self.indent > column:
            self.indent = self.indents.pop()
            self.tokens.append(self.tok("BEND"))

    def add_indent(self, column):
        if self.indent < column:
            self.indents.append(self.indent)
            self.indent = column
            return True
        return False

    def fetch_value(self):
        key = self.keys.pop(self.flow_level, None)
        if key is not None:
            self.tokens.insert(key.token_number,
                               _Token("KEY", key.line + 1))
            if not self.flow_level and self.add_indent(key.column):
                self.tokens.insert(key.token_number,
                                   _Token("BMAP", key.line + 1))
            self.allow_simple_key = False
        else:
            if not self.flow_level:
                if not self.allow_simple_key:
                    self.err("mapping values are not allowed here")
                if self.add_indent(self.column):
                    self.tokens.append(self.tok("BMAP"))
            self.allow_simple_key = not self.flow_level
            self.remove_key()
        self.tokens.append(self.tok("VALUE"))
        self.forward()

    # -- directives, anchors, tags ----------------------------------------
    def scan_directive(self):
        line = self.line + 1
        self.forward()
        name = self.scan_word("a directive")
        if self.peek() not in "\0 " + _BREAKS:
            self.err(f"a directive: unexpected {self.peek()!r}")
        value = None
        if name == "YAML":
            self.skip_spaces()
            major = self.scan_number()
            if self.peek() != ".":
                self.err("a %YAML directive: expected '.'")
            self.forward()
            minor = self.scan_number()
            if self.peek() not in "\0 " + _BREAKS:
                self.err("a %YAML directive: expected a digit or ' '")
            value = (major, minor)
        elif name == "TAG":
            self.skip_spaces()
            handle = self.scan_tag_handle()
            if self.peek() != " ":
                self.err("a %TAG directive: expected ' '")
            self.skip_spaces()
            prefix = self.scan_tag_uri()
            if self.peek() not in "\0 " + _BREAKS:
                self.err("a %TAG directive: expected ' '")
            value = (handle, prefix)
        else:
            while self.peek() not in _END:
                self.forward()
        self.skip_spaces()
        if self.peek() == "#":
            while self.peek() not in _END:
                self.forward()
        if self.peek() not in _END:
            self.err("a directive: expected a comment or a line break")
        self.line_break()
        return _Token("DIRECTIVE", line, (name, value))

    def skip_spaces(self):
        while self.peek() == " ":
            self.forward()

    def scan_number(self):
        n = 0
        while "0" <= self.peek(n) <= "9":
            n += 1
        if not n:
            self.err(f"expected a digit, but found {self.peek()!r}")
        value = int(self.prefix(n))
        self.forward(n)
        return value

    def scan_word(self, what):
        n = 0
        while _WORD.match(self.peek(n)):
            n += 1
        if not n:
            self.err(f"{what}: expected alphabetic or numeric character, "
                     f"but found {self.peek()!r}")
        value = self.prefix(n)
        self.forward(n)
        return value

    def scan_anchor(self):
        kind = "ALIAS" if self.peek() == "*" else "ANCHOR"
        tok = self.tok(kind)
        self.forward()
        tok.value = self.scan_word("an " + kind.lower())
        if self.peek() not in "\0 \t\r\n\x85\u2028\u2029?:,]}%@`":
            self.err(f"an {kind.lower()}: expected alphabetic or numeric "
                     f"character, but found {self.peek()!r}")
        return tok

    def scan_tag(self):
        tok = self.tok("TAG")
        ch = self.peek(1)
        if ch == "<":
            handle = None
            self.forward(2)
            suffix = self.scan_tag_uri()
            if self.peek() != ">":
                self.err(f"a tag: expected '>', but found {self.peek()!r}")
            self.forward()
        elif ch in _BLANK_END:
            handle, suffix = None, "!"
            self.forward()
        else:
            n, use_handle = 1, False
            while ch not in "\0 " + _BREAKS:
                if ch == "!":
                    use_handle = True
                    break
                n += 1
                ch = self.peek(n)
            if use_handle:
                handle = self.scan_tag_handle()
            else:
                handle = "!"
                self.forward()
            suffix = self.scan_tag_uri()
        if self.peek() not in "\0 " + _BREAKS:
            self.err(f"a tag: expected ' ', but found {self.peek()!r}")
        tok.value = (handle, suffix)
        return tok

    def scan_tag_handle(self):
        if self.peek() != "!":
            self.err(f"a tag: expected '!', but found {self.peek()!r}")
        n = 1
        ch = self.peek(n)
        if ch != " ":
            while _WORD.match(ch):
                n += 1
                ch = self.peek(n)
            if ch != "!":
                self.forward(n)
                self.err(f"a tag: expected '!', but found {ch!r}")
            n += 1
        value = self.prefix(n)
        self.forward(n)
        return value

    def scan_tag_uri(self):
        chunks, n = [], 0
        ch = self.peek(n)
        while _URI.match(ch):
            if ch == "%":
                chunks.append(self.prefix(n))
                self.forward(n)
                n = 0
                codes = []
                while self.peek() == "%":
                    self.forward()
                    hx = self.prefix(2)
                    if not re.fullmatch(r"[0-9A-Fa-f]{2}", hx):
                        self.err("a tag: expected a URI escape of 2 "
                                 "hexadecimal digits")
                    codes.append(int(hx, 16))
                    self.forward(2)
                try:
                    chunks.append(bytes(codes).decode("utf-8"))
                except UnicodeDecodeError as e:
                    self.err(f"a tag: {e}")
            else:
                n += 1
            ch = self.peek(n)
        if n:
            chunks.append(self.prefix(n))
            self.forward(n)
        if not chunks:
            self.err(f"a tag: expected URI, but found {ch!r}")
        return "".join(chunks)

    # -- scalars ------------------------------------------------------------
    def scan_block_scalar(self, folded):
        tok = self.tok("SCALAR")
        self.forward()
        chomping = increment = None
        ch = self.peek()
        for _ in range(2):
            if ch in "+-" and chomping is None:
                chomping = ch == "+"
                self.forward()
            elif ch in "0123456789" and increment is None:
                increment = int(ch)
                if not increment:
                    self.err("a block scalar: expected indentation "
                             "indicator in the range 1-9, but found 0")
                self.forward()
            ch = self.peek()
        if ch not in "\0 " + _BREAKS:
            self.err("a block scalar: expected chomping or indentation "
                     f"indicators, but found {ch!r}")
        self.skip_spaces()
        if self.peek() == "#":
            while self.peek() not in _END:
                self.forward()
        if self.peek() not in _END:
            self.err("a block scalar: expected a comment or a line break, "
                     f"but found {self.peek()!r}")
        self.line_break()
        min_indent = max(self.indent + 1, 1)
        if increment is None:
            breaks, max_indent = [], 0
            while self.peek() in " " + _BREAKS:
                if self.peek() != " ":
                    breaks.append(self.line_break())
                else:
                    self.forward()
                    max_indent = max(max_indent, self.column)
            indent = max(min_indent, max_indent)
        else:
            indent = min_indent + increment - 1
            breaks = self.block_breaks(indent)
        chunks, line_break = [], ""
        while self.column == indent and self.peek() != "\0":
            chunks.extend(breaks)
            leading_non_space = self.peek() not in " \t"
            n = 0
            while self.peek(n) not in _END:
                n += 1
            chunks.append(self.prefix(n))
            self.forward(n)
            line_break = self.line_break()
            breaks = self.block_breaks(indent)
            if self.column == indent and self.peek() != "\0":
                if folded and line_break == "\n" and leading_non_space \
                        and self.peek() not in " \t":
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        tok.value = "".join(chunks)
        return tok

    def block_breaks(self, indent):
        chunks = []
        while self.column < indent and self.peek() == " ":
            self.forward()
        while self.peek() in _BREAKS:
            chunks.append(self.line_break())
            while self.column < indent and self.peek() == " ":
                self.forward()
        return chunks

    def scan_flow_scalar(self, double):
        tok = self.tok("SCALAR")
        quote = self.peek()
        self.forward()
        chunks = self.flow_non_spaces(double)
        while self.peek() != quote:
            chunks += self.flow_spaces()
            chunks += self.flow_non_spaces(double)
        self.forward()
        tok.value = "".join(chunks)
        return tok

    def flow_non_spaces(self, double):
        chunks = []
        while True:
            n = 0
            while self.peek(n) not in "'\"\\\0 \t" + _BREAKS:
                n += 1
            if n:
                chunks.append(self.prefix(n))
                self.forward(n)
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.forward(2)
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.forward()
            elif double and ch == "\\":
                self.forward()
                ch = self.peek()
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                    self.forward()
                elif ch in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[ch]
                    self.forward()
                    hx = self.prefix(n)
                    if not re.fullmatch(f"[0-9A-Fa-f]{{{n}}}", hx):
                        self.err(f"a double-quoted scalar: expected escape "
                                 f"sequence of {n} hexadecimal numbers")
                    chunks.append(chr(int(hx, 16)))
                    self.forward(n)
                elif ch in _BREAKS:
                    self.line_break()
                    chunks += self.flow_breaks()
                else:
                    self.err(f"a double-quoted scalar: found unknown escape "
                             f"character {ch!r}")
            else:
                return chunks

    def flow_spaces(self):
        n = 0
        while self.peek(n) in " \t":
            n += 1
        spaces = self.prefix(n)
        self.forward(n)
        ch = self.peek()
        if ch == "\0":
            self.err("a quoted scalar: found unexpected end of stream")
        if ch in _BREAKS:
            line_break = self.line_break()
            breaks = self.flow_breaks()
            chunks = []
            if line_break != "\n":
                chunks.append(line_break)
            elif not breaks:
                chunks.append(" ")
            return chunks + breaks
        return [spaces]

    def flow_breaks(self):
        chunks = []
        while True:
            if self.prefix(3) in ("---", "...") and \
                    self.peek(3) in _BLANK_END:
                self.err("a quoted scalar: found unexpected document "
                         "separator")
            while self.peek() in " \t":
                self.forward()
            if self.peek() in _BREAKS:
                chunks.append(self.line_break())
            else:
                return chunks

    def scan_plain(self):
        tok = self.tok("SCALAR", plain=True)
        chunks, spaces = [], []
        indent = self.indent + 1
        stop = _BLANK_END + (",[]{}" if self.flow_level else "")
        while True:
            n = 0
            if self.peek() == "#":
                break
            while True:
                ch = self.peek(n)
                if ch in _BLANK_END or (ch == ":" and self.peek(n + 1)
                                        in stop) or (
                        self.flow_level and ch in ",?[]{}"):
                    break
                n += 1
            if not n:
                break
            self.allow_simple_key = False
            chunks += spaces
            chunks.append(self.prefix(n))
            self.forward(n)
            spaces = self.plain_spaces()
            if not spaces or self.peek() == "#" or (
                    not self.flow_level and self.column < indent):
                break
        tok.value = "".join(chunks)
        return tok

    def plain_spaces(self):
        n = 0
        while self.peek(n) == " ":
            n += 1
        spaces = self.prefix(n)
        self.forward(n)
        if self.peek() not in _BREAKS:
            return [spaces] if spaces else []
        line_break = self.line_break()
        self.allow_simple_key = True
        if self.prefix(3) in ("---", "...") and self.peek(3) in _BLANK_END:
            return []
        breaks = []
        while self.peek() in " " + _BREAKS:
            if self.peek() == " ":
                self.forward()
            else:
                breaks.append(self.line_break())
                if self.prefix(3) in ("---", "...") and \
                        self.peek(3) in _BLANK_END:
                    return []
        chunks = []
        if line_break != "\n":
            chunks.append(line_break)
        elif not breaks:
            chunks.append(" ")
        return chunks + breaks


# ---------------------------------------------------------------------------
# nodes: the parser and composer in one pass

class _Node:
    """A scalar (value str), seq (list of nodes) or map (list of node
    pairs) with its tag, resolved as PyYAML's composer resolves it."""
    __slots__ = ("kind", "tag", "value", "line")

    def __init__(self, kind, tag, value, line):
        if tag is None:
            tag = resolve(value) if kind == "scalar" else TAG + kind
        self.kind, self.tag, self.value, self.line = kind, tag, value, line


_RESOLVERS = [
    ("bool", re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false"
                        r"|False|FALSE|on|On|ON|off|Off|OFF)$"),
     "yYnNtTfFoO"),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""", re.X), "-+0123456789."),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
        |[-+]?0[0-7_]+
        |[-+]?(?:0|[1-9][0-9_]*)
        |[-+]?0x[0-9a-fA-F_]+
        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X), "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", re.compile(r"^(?: ~ |null|Null|NULL | )$", re.X), "~nN"),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
        |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
        (?:[Tt]|[ \t]+)[0-9][0-9]?
        :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X),
     "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
]


def resolve(value: str) -> str:
    """The tag PyYAML's resolver gives a plain scalar: TAG + "str", "null",
    "bool", "int", "float", "timestamp", "merge" or "value"."""
    if value == "":
        return TAG + "null"
    for name, regex, first in _RESOLVERS:
        if value[0] in first and regex.match(value):
            return TAG + name
    return TAG + "str"


class _Parser:
    """PyYAML's Parser and Composer: the token list -> one document's node
    tree, anchors resolved."""

    def __init__(self, tokens):
        self.tokens, self.i = tokens, 0
        self.anchors = {}
        self.handles = {}

    def peek(self):
        return self.tokens[self.i]

    def check(self, *kinds):
        return self.tokens[self.i].kind in kinds

    def get(self):
        t = self.tokens[self.i]
        self.i += 1
        return t

    def expected(self, what):
        t = self.peek()
        fail(t.line, f"{what}, but found {t.kind}")

    def document(self):
        """The single document's node, or None for an empty stream."""
        self.get()                                       # STREAM-START
        node = None
        if self.check("DIRECTIVE", "DOC-START", "STREAM-END"):
            node = self.explicit_document()
        else:
            self.directives()
            node = self.node(block=True)
            if self.check("DOC-END"):
                self.get()
        if node is not None and not self.check("STREAM-END"):
            while self.check("DOC-END"):
                self.get()
            if not self.check("STREAM-END"):
                fail(self.peek().line, "expected a single document in the "
                     "stream, but found another document")
        return node

    def explicit_document(self):
        while self.check("DOC-END"):
            self.get()
        if self.check("STREAM-END"):
            return None
        self.directives()
        if not self.check("DOC-START"):
            self.expected("expected '<document start>'")
        self.get()
        if self.check("DIRECTIVE", "DOC-START", "DOC-END", "STREAM-END"):
            node = self.empty(self.peek().line)
        else:
            node = self.node(block=True)
        if self.check("DOC-END"):
            self.get()
        return node

    def directives(self):
        version, self.handles = None, {}
        while self.check("DIRECTIVE"):
            t = self.get()
            name, value = t.value
            if name == "YAML":
                if version is not None:
                    fail(t.line, "found duplicate YAML directive")
                if value[0] != 1:
                    fail(t.line, "found incompatible YAML document "
                         "(version 1.* is required)")
                version = value
            elif name == "TAG":
                if value[0] in self.handles:
                    fail(t.line, f"duplicate tag handle {value[0]!r}")
                self.handles[value[0]] = value[1]
        self.handles.setdefault("!", "!")
        self.handles.setdefault("!!", TAG)

    def empty(self, line, tag=None, anchor=None):
        node = _Node("scalar", tag, "", line)
        return self.register(anchor, node)

    def register(self, anchor, node):
        if anchor is not None:
            self.anchors[anchor] = node
        return node

    def node(self, block=False, indentless=False):
        if self.check("ALIAS"):
            t = self.get()
            if t.value not in self.anchors:
                fail(t.line, f"found undefined alias {t.value!r}")
            return self.anchors[t.value]
        anchor = tag = None
        line = self.peek().line
        for _ in range(2):
            if self.check("ANCHOR") and anchor is None:
                anchor = self.get().value
            elif self.check("TAG") and tag is None:
                t = self.get()
                handle, suffix = t.value
                if handle is not None:
                    if handle not in self.handles:
                        fail(t.line, f"found undefined tag handle "
                             f"{handle!r}")
                    tag = self.handles[handle] + suffix
                else:
                    tag = suffix
        if anchor is not None and anchor in self.anchors:
            fail(line, f"found duplicate anchor {anchor!r}")
        bang = tag == "!"                # PyYAML resolves a `!` scalar
        if bang:
            tag = None
        if indentless and self.check("BENTRY"):
            node = self.register(anchor, _Node("seq", tag, [], line))
            while self.check("BENTRY"):
                t = self.get()
                if self.check("BENTRY", "KEY", "VALUE", "BEND"):
                    node.value.append(self.empty(t.line))
                else:
                    node.value.append(self.node(block=True))
            return node
        if self.check("SCALAR"):
            t = self.get()
            if tag is None:
                tag = resolve(t.value) if t.plain or bang else TAG + "str"
            node = _Node("scalar", tag, t.value, line)
            return self.register(anchor, node)
        if self.check("FSEQ", "FMAP"):
            kind = "seq" if self.check("FSEQ") else "map"
            return self.flow_collection(kind, anchor, tag, line)
        if block and self.check("BSEQ"):
            node = self.register(anchor, _Node("seq", tag, [], line))
            self.get()
            while self.check("BENTRY"):
                t = self.get()
                if self.check("BENTRY", "BEND"):
                    node.value.append(self.empty(t.line))
                else:
                    node.value.append(self.node(block=True))
            if not self.check("BEND"):
                self.expected("while parsing a block collection: expected "
                              "<block end>")
            self.get()
            return node
        if block and self.check("BMAP"):
            node = self.register(anchor, _Node("map", tag, [], line))
            self.get()
            while self.check("KEY"):
                t = self.get()
                if self.check("KEY", "VALUE", "BEND"):
                    key = self.empty(t.line)
                else:
                    key = self.node(block=True, indentless=True)
                if self.check("VALUE"):
                    t = self.get()
                    if self.check("KEY", "VALUE", "BEND"):
                        value = self.empty(t.line)
                    else:
                        value = self.node(block=True, indentless=True)
                else:
                    value = self.empty(self.peek().line)
                node.value.append((key, value))
            if not self.check("BEND"):
                self.expected("while parsing a block mapping: expected "
                              "<block end>")
            self.get()
            return node
        if anchor is not None or tag is not None or bang:
            return self.empty(line, tag, anchor)
        self.expected(f"while parsing a {'block' if block else 'flow'} "
                      "node: expected the node content")

    def flow_pair(self, end: str):
        """A `? key : value` entry of a flow collection closed by `end`,
        past its KEY token; either side empty where absent."""
        t = self.get()
        if self.check("VALUE", "FENTRY", end):
            key = self.empty(t.line)
        else:
            key = self.node()
        if not self.check("VALUE"):
            return key, self.empty(self.peek().line)
        t = self.get()
        if self.check("FENTRY", end):
            return key, self.empty(t.line)
        return key, self.node()

    def flow_collection(self, kind, anchor, tag, line):
        """A flow sequence (a `key: value` entry a one-pair mapping) or a
        flow mapping (a bare entry a key with an empty value)."""
        end, what = ("FSEQ-END", "']'") if kind == "seq" else \
            ("FMAP-END", "'}'")
        node = self.register(anchor, _Node(kind, tag, [], line))
        self.get()
        first = True
        while not self.check(end):
            if not first:
                if not self.check("FENTRY"):
                    self.expected(f"while parsing a flow {kind}: expected "
                                  f"',' or {what}")
                self.get()
            first = False
            if self.check("KEY"):
                pair_line = self.peek().line
                pair = self.flow_pair(end)
                if kind == "seq":
                    node.value.append(_Node("map", None, [pair], pair_line))
                else:
                    node.value.append(pair)
            elif not self.check(end):
                item = self.node()
                node.value.append(item if kind == "seq" else
                                  (item, self.empty(self.peek().line)))
        self.get()
        return node


# ---------------------------------------------------------------------------
# the safe constructor

_TIMESTAMP = re.compile(
    r"""^(?P<year>[0-9][0-9][0-9][0-9])
        -(?P<month>[0-9][0-9]?)
        -(?P<day>[0-9][0-9]?)
        (?:(?:[Tt]|[ \t]+)
        (?P<hour>[0-9][0-9]?)
        :(?P<minute>[0-9][0-9])
        :(?P<second>[0-9][0-9])
        (?:\.(?P<fraction>[0-9]*))?
        (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
        (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)


def _sexagesimal(parts, zero):
    value, base = zero, 1
    for digit in reversed(parts):
        value += digit * base
        base *= 60
    return value


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal([int(p) for p in value.split(":")], 0)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal([float(p) for p in value.split(":")],
                                   0.0)
    return sign * float(value)


def _timestamp(value: str):
    v = _TIMESTAMP.match(value).groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = int((v["fraction"] or "")[:6].ljust(6, "0"))
    tz = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]),
                                   minutes=int(v["tz_minute"] or 0))
        tz = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]),
                             int(v["minute"]), int(v["second"]), fraction,
                             tzinfo=tz)


def _bool(value: str) -> bool:
    return {"yes": True, "no": False, "true": True, "false": False,
            "on": True, "off": False}[value.lower()]


def _binary(value: str) -> bytes:
    return base64.decodebytes(value.encode("ascii"))


_SCALARS = {"str": str, "null": lambda v: None, "bool": _bool, "int": _int,
            "float": _float, "timestamp": _timestamp, "binary": _binary}


class _Constructor:
    def __init__(self):
        self.made = {}

    def scalar(self, node):
        if node.kind == "map":
            for k, v in node.value:
                if k.tag == TAG + "value":
                    return self.scalar(v)
        if node.kind != "scalar":
            fail(node.line, f"expected a scalar node, but found {node.kind}")
        return node.value

    def flatten(self, node):
        merge, i = [], 0
        while i < len(node.value):
            k, v = node.value[i]
            if k.tag == TAG + "merge":
                del node.value[i]
                if v.kind == "map":
                    self.flatten(v)
                    merge.extend(v.value)
                elif v.kind == "seq":
                    sub = []
                    for s in v.value:
                        if s.kind != "map":
                            fail(s.line, "expected a mapping for merging, "
                                 f"but found {s.kind}")
                        self.flatten(s)
                        sub.append(s.value)
                    for pairs in reversed(sub):
                        merge.extend(pairs)
                else:
                    fail(v.line, "expected a mapping or list of mappings "
                         f"for merging, but found {v.kind}")
            elif k.tag == TAG + "value":
                k.tag = TAG + "str"
                i += 1
            else:
                i += 1
        if merge:
            node.value = merge + node.value

    def pairs(self, node):
        if node.kind != "map":
            fail(node.line, f"expected a mapping node, but found "
                 f"{node.kind}")
        self.flatten(node)
        out = []
        for k, v in node.value:
            key = self.build(k)
            try:
                hash(key)
            except TypeError:
                fail(k.line, "found unhashable key")
            out.append((key, self.build(v)))
        return out

    def build(self, node):
        if id(node) in self.made:
            return self.made[id(node)]
        tag = node.tag
        name = tag[len(TAG):] if tag.startswith(TAG) else None
        try:
            if name in _SCALARS:
                out = _SCALARS[name](self.scalar(node))
            elif name == "seq":
                if node.kind != "seq":
                    fail(node.line, "expected a sequence node, but found "
                         f"{node.kind}")
                out = self.made[id(node)] = []
                out.extend(self.build(n) for n in node.value)
            elif name == "map":
                out = self.made[id(node)] = {}
                out.update(self.pairs(node))
            elif name == "set":
                out = self.made[id(node)] = set()
                out.update(k for k, _ in self.pairs(node))
            elif name in ("omap", "pairs"):
                out = self.made[id(node)] = []
                if node.kind != "seq":
                    fail(node.line, f"expected a sequence, but found "
                         f"{node.kind}")
                for s in node.value:
                    if s.kind != "map" or len(s.value) != 1:
                        fail(s.line, "expected a single mapping item")
                    k, v = s.value[0]
                    out.append((self.build(k), self.build(v)))
            else:
                fail(node.line, "could not determine a constructor for the "
                     f"tag {tag!r}")
        except (KeyError, IndexError, AttributeError, binascii.Error,
                UnicodeEncodeError) as e:
            fail(node.line, f"cannot construct {tag!r} from "
                 f"{node.value!r}: {e!r}")
        except ValueError as e:
            if str(e).startswith("config line"):
                raise
            fail(node.line, f"cannot construct {tag!r}: {e}")
        self.made[id(node)] = out
        return out


def safe_load(text: str):
    """What `yaml.safe_load(text)` returns for a str (see the module
    docstring); ValueError naming the line where it raises."""
    node = _Parser(_Scanner(text).tokens).document()
    return None if node is None else _Constructor().build(node)
