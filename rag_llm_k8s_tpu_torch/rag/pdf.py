"""Dependency-free PDF text extraction (a copy of the JAX package's module).

The original service extracts PDF text with PyPDF2 (``PdfReader`` → per-page
``extract_text()`` concatenated with ``"\\n"``). The framework carries its
own extractor instead: host-side Python, since PDF parsing is I/O-bound.

Supported (covers the bundled Technology Radar corpus and ordinary text PDFs):
- classic ``N 0 obj`` bodies AND PDF-1.5+ compressed object streams (ObjStm);
- FlateDecode streams;
- page content streams: ``Tj``, ``'``, ``"``, ``TJ`` show-text operators with
  paren/hex strings, font switching via ``Tf``;
- per-font ``/ToUnicode`` CMaps (``bfchar``/``bfrange``) for both 1-byte
  simple fonts and 2-byte Identity-H Type0 fonts; latin-1 fallback otherwise.

Out of scope (rare in text corpora): LZW/DCT content, encryption, Type3 glyph
programs. Unknown constructs degrade to skipped bytes, never exceptions.
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# object model + parser
# ---------------------------------------------------------------------------


class Ref:
    __slots__ = ("num",)

    def __init__(self, num: int):
        self.num = num

    def __repr__(self):
        return f"Ref({self.num})"


class Name(str):
    """A PDF /Name (distinct from string values)."""


_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


def _skip_ws(data: bytes, pos: int) -> int:
    n = len(data)
    while pos < n:
        c = data[pos : pos + 1]
        if c in (b"%",):  # comment to EOL
            while pos < n and data[pos] not in b"\r\n":
                pos += 1
        elif c and c in _WS:
            pos += 1
        else:
            break
    return pos


def parse_object(data: bytes, pos: int):
    """Parse one PDF object at ``pos``; returns (value, new_pos)."""
    pos = _skip_ws(data, pos)
    c = data[pos : pos + 1]
    if c == b"<":
        if data[pos : pos + 2] == b"<<":
            return _parse_dict(data, pos)
        return _parse_hex_string(data, pos)
    if c == b"(":
        return _parse_literal_string(data, pos)
    if c == b"/":
        return _parse_name(data, pos)
    if c == b"[":
        return _parse_array(data, pos)
    if c in b"+-.0123456789":
        return _parse_number_or_ref(data, pos)
    if data[pos : pos + 4] == b"true":
        return True, pos + 4
    if data[pos : pos + 5] == b"false":
        return False, pos + 5
    if data[pos : pos + 4] == b"null":
        return None, pos + 4
    raise ValueError(f"unparseable object at {pos}: {data[pos:pos+20]!r}")


def _parse_dict(data: bytes, pos: int):
    pos += 2  # <<
    out: Dict[str, object] = {}
    while True:
        pos = _skip_ws(data, pos)
        if data[pos : pos + 2] == b">>":
            return out, pos + 2
        key, pos = _parse_name(data, pos)
        val, pos = parse_object(data, pos)
        out[str(key)] = val


def _parse_array(data: bytes, pos: int):
    pos += 1  # [
    out: List[object] = []
    while True:
        pos = _skip_ws(data, pos)
        if data[pos : pos + 1] == b"]":
            return out, pos + 1
        val, pos = parse_object(data, pos)
        out.append(val)


def _parse_name(data: bytes, pos: int):
    pos += 1  # /
    start = pos
    n = len(data)
    while pos < n and data[pos] not in _WS and data[pos] not in _DELIM:
        pos += 1
    raw = data[start:pos]
    # #xx escapes
    if b"#" in raw:
        raw = re.sub(rb"#([0-9A-Fa-f]{2})", lambda m: bytes([int(m.group(1), 16)]), raw)
    return Name(raw.decode("latin-1")), pos


def _parse_number_or_ref(data: bytes, pos: int):
    m = re.match(rb"[+-]?\d*\.?\d+", data[pos:])
    tok = m.group(0)
    end = pos + len(tok)
    if b"." not in tok:
        # lookahead for "G R" (indirect reference)
        m2 = re.match(rb"\s+(\d+)\s+R\b", data[end : end + 16])
        if m2:
            return Ref(int(tok)), end + m2.end()
        return int(tok), end
    return float(tok), end


def _parse_literal_string(data: bytes, pos: int):
    pos += 1  # (
    out = bytearray()
    depth = 1
    n = len(data)
    while pos < n:
        c = data[pos]
        if c == 0x5C:  # backslash
            pos += 1
            e = data[pos : pos + 1]
            mapping = {b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b", b"f": b"\x0c",
                       b"(": b"(", b")": b")", b"\\": b"\\"}
            if e in mapping:
                out += mapping[e]
                pos += 1
            elif (m := re.match(rb"[0-7]{1,3}", data[pos:])) is not None:  # octal
                out.append(int(m.group(0), 8) & 0xFF)
                pos += len(m.group(0))
            elif e in (b"\n", b"\r"):  # line continuation
                pos += 1
                if e == b"\r" and data[pos : pos + 1] == b"\n":
                    pos += 1
            else:
                pos += 1
        elif c == 0x28:  # (
            depth += 1
            out.append(c)
            pos += 1
        elif c == 0x29:  # )
            depth -= 1
            if depth == 0:
                return bytes(out), pos + 1
            out.append(c)
            pos += 1
        else:
            out.append(c)
            pos += 1
    return bytes(out), pos


def _parse_hex_string(data: bytes, pos: int):
    end = data.index(b">", pos)
    hexdata = re.sub(rb"[^0-9A-Fa-f]", b"", data[pos + 1 : end])
    if len(hexdata) % 2:
        hexdata += b"0"
    return bytes.fromhex(hexdata.decode("ascii")), end + 1


# ---------------------------------------------------------------------------
# document: objects, streams, ObjStm expansion
# ---------------------------------------------------------------------------

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b")


class PdfDocument:
    def __init__(self, data: bytes):
        self.data = data
        self.objects: Dict[int, object] = {}
        self.streams: Dict[int, bytes] = {}
        self._scan_body()
        self._expand_object_streams()

    # -- raw scan -----------------------------------------------------------
    def _scan_body(self):
        data = self.data
        for m in _OBJ_RE.finditer(data):
            num = int(m.group(1))
            pos = m.end()
            try:
                val, pos = parse_object(data, pos)
            except (ValueError, IndexError):
                continue
            self.objects[num] = val
            pos = _skip_ws(data, pos)
            if data[pos : pos + 6] == b"stream":
                pos += 6
                if data[pos : pos + 2] == b"\r\n":
                    pos += 2
                elif data[pos : pos + 1] in (b"\n", b"\r"):
                    pos += 1
                length = val.get("Length") if isinstance(val, dict) else None
                if isinstance(length, Ref):
                    length = self.objects.get(length.num)
                if isinstance(length, int):
                    raw = data[pos : pos + length]
                else:
                    end = data.find(b"endstream", pos)
                    raw = data[pos:end].rstrip(b"\r\n")
                self.streams[num] = raw

    def _decode_stream(self, num: int) -> Optional[bytes]:
        raw = self.streams.get(num)
        obj = self.objects.get(num)
        if raw is None or not isinstance(obj, dict):
            return raw
        filt = obj.get("Filter")
        filters = [filt] if isinstance(filt, (Name, str)) else (filt or [])
        out = raw
        for f in filters:
            if str(f) == "FlateDecode":
                try:
                    out = zlib.decompress(out)
                except zlib.error:
                    try:
                        out = zlib.decompressobj().decompress(out)
                    except zlib.error:
                        return None
                parms = obj.get("DecodeParms")
                if isinstance(parms, dict) and parms.get("Predictor", 1) > 1:
                    out = _unpredict(out, parms)
            else:
                return None  # unsupported filter (DCT etc.)
        return out

    def _expand_object_streams(self):
        for num, obj in list(self.objects.items()):
            if not (isinstance(obj, dict) and str(obj.get("Type", "")) == "ObjStm"):
                continue
            payload = self._decode_stream(num)
            if payload is None:
                continue
            n = obj.get("N", 0)
            first = obj.get("First", 0)
            header = payload[:first].split()
            try:
                pairs = [
                    (int(header[2 * i]), int(header[2 * i + 1])) for i in range(n)
                ]
            except (ValueError, IndexError):
                continue
            for objnum, off in pairs:
                try:
                    val, _ = parse_object(payload, first + off)
                except (ValueError, IndexError):
                    continue
                # don't clobber a directly-parsed object (updates win in PDFs,
                # but body scan order already reflects the newest)
                self.objects.setdefault(objnum, val)

    # -- resolution ---------------------------------------------------------
    def deref(self, obj):
        seen = 0
        while isinstance(obj, Ref) and seen < 32:
            obj = self.objects.get(obj.num)
            seen += 1
        return obj

    def stream_for(self, obj) -> Optional[bytes]:
        if isinstance(obj, Ref):
            return self._decode_stream(obj.num)
        return None


def _unpredict(data: bytes, parms: dict) -> bytes:
    """PNG predictors (used by xref/ObjStm streams)."""
    predictor = parms.get("Predictor", 1)
    if predictor < 10:
        return data
    colors = parms.get("Colors", 1)
    bpc = parms.get("BitsPerComponent", 8)
    columns = parms.get("Columns", 1)
    rowlen = (colors * bpc * columns + 7) // 8
    stride = rowlen + 1
    out = bytearray()
    prev = bytearray(rowlen)
    for r in range(0, len(data) - stride + 1, stride):
        ft = data[r]
        row = bytearray(data[r + 1 : r + 1 + rowlen])
        if ft == 2:  # Up
            for i in range(rowlen):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ft == 1:  # Sub
            for i in range(1, rowlen):
                row[i] = (row[i] + row[i - 1]) & 0xFF
        out += row
        prev = row
    return bytes(out)


# ---------------------------------------------------------------------------
# fonts: ToUnicode CMaps
# ---------------------------------------------------------------------------

_BFCHAR_RE = re.compile(rb"beginbfchar(.*?)endbfchar", re.S)
_BFRANGE_RE = re.compile(rb"beginbfrange(.*?)endbfrange", re.S)
_HEX_RE = re.compile(rb"<([0-9A-Fa-f]+)>")


class FontDecoder:
    def __init__(self, two_byte: bool, cmap: Optional[Dict[int, str]]):
        self.two_byte = two_byte
        self.cmap = cmap

    def decode(self, raw: bytes) -> str:
        step = 2 if self.two_byte else 1
        out = []
        for i in range(0, len(raw) - step + 1, step):
            code = int.from_bytes(raw[i : i + step], "big")
            if self.cmap is not None:
                out.append(self.cmap.get(code, ""))
            else:
                out.append(chr(code) if code < 0x110000 else "")
        return "".join(out)


def parse_tounicode(cmap_bytes: bytes) -> Dict[int, str]:
    mapping: Dict[int, str] = {}

    def utf16(hexstr: bytes) -> str:
        b = bytes.fromhex(hexstr.decode("ascii"))
        try:
            return b.decode("utf-16-be")
        except UnicodeDecodeError:
            return ""

    for block in _BFCHAR_RE.findall(cmap_bytes):
        toks = _HEX_RE.findall(block)
        for i in range(0, len(toks) - 1, 2):
            mapping[int(toks[i], 16)] = utf16(toks[i + 1])
    for block in _BFRANGE_RE.findall(cmap_bytes):
        # two forms: <lo> <hi> <dst>  |  <lo> <hi> [<dst1> <dst2> ...]
        pos = 0
        entries = re.findall(rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*(\[[^\]]*\]|<[0-9A-Fa-f]+>)", block)
        for lo_h, hi_h, dst in entries:
            lo, hi = int(lo_h, 16), int(hi_h, 16)
            if dst.startswith(b"["):
                dsts = _HEX_RE.findall(dst)
                for off, d in enumerate(dsts):
                    if lo + off <= hi:
                        mapping[lo + off] = utf16(d)
            else:
                base_hex = dst.strip(b"<>")
                base_bytes = bytes.fromhex(base_hex.decode("ascii"))
                base = int.from_bytes(base_bytes[-2:], "big") if len(base_bytes) >= 2 else int(base_hex, 16)
                prefix = base_bytes[:-2]
                for code in range(lo, hi + 1):
                    val = base + (code - lo)
                    try:
                        s = (prefix + val.to_bytes(2, "big")).decode("utf-16-be")
                    except (UnicodeDecodeError, OverflowError):
                        s = ""
                    mapping[code] = s
        _ = pos
    return mapping


# ---------------------------------------------------------------------------
# content stream interpretation
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    rb"\((?:[^()\\]|\\.|\([^)]*\))*\)"  # literal string (1 nesting level fast path)
    rb"|<<|>>|<[0-9A-Fa-f\s]*>"
    rb"|\[|\]"
    rb"|/[^\s()<>\[\]{}/%]*"
    rb"|[+-]?\d*\.?\d+"
    rb"|[A-Za-z'\"*]+"
)


def _extract_page_text(content: bytes, fonts: Dict[str, FontDecoder]) -> str:
    out: List[str] = []
    stack: List[object] = []
    cur_font: Optional[FontDecoder] = None
    default = FontDecoder(two_byte=False, cmap=None)

    def show(raw: bytes):
        dec = (cur_font or default).decode(raw)
        if dec:
            out.append(dec)

    for m in _TOKEN_RE.finditer(content):
        tok = m.group(0)
        c = tok[:1]
        if c == b"(":
            val, _ = _parse_literal_string(tok, 0)
            stack.append(val)
        elif c == b"<" and tok != b"<<":
            val, _ = _parse_hex_string(tok, 0)
            stack.append(val)
        elif c == b"/":
            stack.append(Name(tok[1:].decode("latin-1")))
        elif c in b"+-.0123456789":
            stack.append(float(tok))
        elif tok == b"[":
            stack.append("[")
        elif tok == b"]":
            pass
        elif tok in (b"<<", b">>"):
            pass
        else:  # operator
            op = tok
            if op == b"Tf" and len(stack) >= 2:
                name = stack[-2]
                if isinstance(name, Name):
                    cur_font = fonts.get(str(name), cur_font)
            elif op == b"Tj" and stack and isinstance(stack[-1], bytes):
                show(stack[-1])
            elif op in (b"'", b'"'):
                if stack and isinstance(stack[-1], bytes):
                    out.append("\n")
                    show(stack[-1])
            elif op == b"TJ":
                # consume back to the matching "[" marker
                i = len(stack) - 1
                items: List[object] = []
                while i >= 0 and stack[i] != "[":
                    items.append(stack[i])
                    i -= 1
                for item in reversed(items):
                    if isinstance(item, bytes):
                        show(item)
                    elif isinstance(item, float) and item < -150:
                        out.append(" ")  # large negative kern ≈ word gap
                del stack[max(i, 0):]
            elif op in (b"Td", b"TD", b"T*", b"Tm", b"BT"):
                if out and not out[-1].endswith(("\n", " ")):
                    out.append("\n")
            stack.clear()  # every operator consumes its operands
    return "".join(out)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _pages_in_reading_order(doc: PdfDocument) -> List[dict]:
    """Walk the /Pages tree from the catalog (the spec's reading order, what
    PyPDF2's ``reader.pages`` yields); fall back to object-number order only
    if no catalog tree is parseable."""
    catalog = next(
        (
            obj
            for _, obj in sorted(doc.objects.items())
            if isinstance(obj, dict) and str(obj.get("Type", "")) == "Catalog"
        ),
        None,
    )
    pages: List[dict] = []
    seen: set = set()

    def walk(node_ref):
        if isinstance(node_ref, Ref):
            if node_ref.num in seen:  # cycle guard
                return
            seen.add(node_ref.num)
        node = doc.deref(node_ref)
        if not isinstance(node, dict):
            return
        t = str(node.get("Type", ""))
        if t == "Page":
            pages.append(node)
        elif t == "Pages" or "Kids" in node:
            kids = doc.deref(node.get("Kids")) or []
            for kid in kids:
                walk(kid)

    if catalog is not None:
        walk(catalog.get("Pages"))
    if not pages:  # fallback: no walkable tree
        pages = [
            obj
            for _, obj in sorted(doc.objects.items())
            if isinstance(obj, dict) and str(obj.get("Type", "")) == "Page"
        ]
    return pages


def extract_text(data: bytes) -> str:
    """Whole-document text: per-page text joined with ``"\\n"`` (as the
    original service's PyPDF2 extraction joins pages)."""
    doc = PdfDocument(data)
    pages = _pages_in_reading_order(doc)
    texts: List[str] = []
    for page in pages:
        fonts = _page_fonts(doc, page)
        content = page.get("Contents")
        chunks: List[bytes] = []
        for ref in content if isinstance(content, list) else [content]:
            s = doc.stream_for(ref)
            if s:
                chunks.append(s)
        if not chunks:
            texts.append("")
            continue
        texts.append(_extract_page_text(b"\n".join(chunks), fonts))
    return "\n".join(texts) + ("\n" if texts else "")


def _page_fonts(doc: PdfDocument, page: dict) -> Dict[str, FontDecoder]:
    fonts: Dict[str, FontDecoder] = {}
    res = doc.deref(page.get("Resources"))
    if not isinstance(res, dict):
        return fonts
    fdict = doc.deref(res.get("Font"))
    if not isinstance(fdict, dict):
        return fonts
    for fname, fref in fdict.items():
        fobj = doc.deref(fref)
        if not isinstance(fobj, dict):
            continue
        subtype = str(fobj.get("Subtype", ""))
        two_byte = subtype == "Type0" and str(fobj.get("Encoding", "")) in (
            "Identity-H",
            "Identity-V",
        )
        cmap = None
        tu = fobj.get("ToUnicode")
        if tu is not None:
            cm_bytes = doc.stream_for(tu)
            if cm_bytes:
                cmap = parse_tounicode(cm_bytes)
        fonts[str(fname)] = FontDecoder(two_byte=two_byte, cmap=cmap)
    return fonts


def extract_text_from_file(path: str) -> str:
    with open(path, "rb") as f:
        return extract_text(f.read())
