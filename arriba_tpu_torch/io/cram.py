"""CRAM 3.0/3.1 reader (and a writer used for tests).

Reference parity: the reference binary reads CRAM through htslib
(read_chimeric_alignments.cpp:588 sam_read1 — format dispatch inside
htslib). This is a clean-room implementation of the CRAM 3.0 specification:
ITF8/LTF8 varints, containers/slices/blocks, block compression methods
raw/gzip/bzip2/lzma/rANS-4x8 (order 0 and 1), the codec set htslib emits
(EXTERNAL, HUFFMAN, BETA, GAMMA, SUBEXP, BYTE_ARRAY_LEN, BYTE_ARRAY_STOP),
reference-based sequence reconstruction via the substitution matrix, and
detached/downstream mate resolution.

Sequence reconstruction requires the reference FASTA the file was written
against (arriba's -a assembly); contigs absent from the assembly decode
with 'N' placeholders, which only affects uninteresting contigs.
"""

from __future__ import annotations

import bz2
import io
import lzma
import struct
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .._native_build import engine
from ..constants import make_cigar_word

# ---------------------------------------------------------------------------
# varints

def read_itf8(buf: io.BytesIO) -> int:
    b0 = buf.read(1)[0]
    if b0 < 0x80:
        value = b0
    elif b0 < 0xC0:
        value = ((b0 & 0x3F) << 8) | buf.read(1)[0]
    elif b0 < 0xE0:
        b = buf.read(2)
        value = ((b0 & 0x1F) << 16) | (b[0] << 8) | b[1]
    elif b0 < 0xF0:
        b = buf.read(3)
        value = ((b0 & 0x0F) << 24) | (b[0] << 16) | (b[1] << 8) | b[2]
    else:
        b = buf.read(4)
        value = (((b0 & 0x0F) << 28) | (b[0] << 20) | (b[1] << 12)
                 | (b[2] << 4) | (b[3] & 0x0F))
    if value >= 1 << 31:
        value -= 1 << 32
    return value


def write_itf8(value: int) -> bytes:
    value &= 0xFFFFFFFF
    if value < 0x80:
        return bytes([value])
    if value < 0x4000:
        return bytes([0x80 | (value >> 8), value & 0xFF])
    if value < 0x200000:
        return bytes([0xC0 | (value >> 16), (value >> 8) & 0xFF, value & 0xFF])
    if value < 0x10000000:
        return bytes([0xE0 | (value >> 24), (value >> 16) & 0xFF,
                      (value >> 8) & 0xFF, value & 0xFF])
    return bytes([0xF0 | ((value >> 28) & 0x0F), (value >> 20) & 0xFF,
                  (value >> 12) & 0xFF, (value >> 4) & 0xFF, value & 0x0F])


def read_ltf8(buf: io.BytesIO) -> int:
    b0 = buf.read(1)[0]
    n_extra = 0
    mask = 0x80
    while n_extra < 8 and (b0 & mask):
        n_extra += 1
        mask >>= 1
    if n_extra == 0:
        value = b0
    elif n_extra < 8:
        value = b0 & ((1 << (7 - n_extra)) - 1)
        for byte in buf.read(n_extra):
            value = (value << 8) | byte
    else:
        value = 0
        for byte in buf.read(8):
            value = (value << 8) | byte
    if value >= 1 << 63:
        value -= 1 << 64
    return value


def write_ltf8(value: int) -> bytes:
    value &= 0xFFFFFFFFFFFFFFFF
    if value < 0x80:
        return bytes([value])
    # simplest valid form: 0xFF prefix + 8 big-endian bytes
    return bytes([0xFF]) + value.to_bytes(8, "big")


# ---------------------------------------------------------------------------
# rANS 4x8 (block compression method 4), order 0 and 1 — decoder only

RANS_TF_SHIFT = 12
RANS_TOTFREQ = 1 << RANS_TF_SHIFT


def _rans_read_freq_table(data: bytes, pos: int) -> Tuple[Dict[int, Tuple[int, int]], int]:
    """Symbol -> (cumulative, frequency); returns (table, new_pos)."""
    freqs: Dict[int, int] = {}
    sym = data[pos]; pos += 1
    rle = 0
    while True:
        freq = data[pos]; pos += 1
        if freq >= 128:
            freq = ((freq & 127) << 8) | data[pos]; pos += 1
        freqs[sym] = freq
        if rle > 0:
            rle -= 1
            sym += 1
        elif pos < len(data) and data[pos] == sym + 1:
            sym = data[pos]; pos += 1
            rle = data[pos]; pos += 1
        else:
            sym = data[pos]; pos += 1
            if sym == 0:
                break
    cumulative = 0
    table: Dict[int, Tuple[int, int]] = {}
    for s in sorted(freqs):
        table[s] = (cumulative, freqs[s])
        cumulative += freqs[s]
    return table, pos


def _rans_lookup(table: Dict[int, Tuple[int, int]]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    sym_of = np.zeros(RANS_TOTFREQ, np.uint8)
    cum_of = np.zeros(RANS_TOTFREQ, np.uint32)
    freq_of = np.zeros(RANS_TOTFREQ, np.uint32)
    for s, (cum, freq) in table.items():
        sym_of[cum:cum + freq] = s
        cum_of[cum:cum + freq] = cum
        freq_of[cum:cum + freq] = freq
    return sym_of, cum_of, freq_of


def rans_decode(data: bytes, expected_size: Optional[int] = None) -> bytes:
    """expected_size (the block header's raw size) rejects corrupt streams
    before the decode loop runs: the embedded 32-bit size field of a
    malformed block can demand gigabytes of output that consume no input
    (rANS emits bytes only on renormalization)."""
    if expected_size is not None and len(data) >= 9:
        embedded = struct.unpack("<I", data[5:9])[0]
        if embedded != expected_size:
            raise ValueError("rANS 4x8: block size field mismatch")
    # the C++ decoder (native/codecs.cpp) when the engine runs; the Python
    # decoder below is the parity reference
    native = engine()
    if native is not None:
        return native.codec_rans4x8(data)
    return _rans_decode_py(data)


def _rans_decode_py(data: bytes) -> bytes:
    order = data[0]
    out_size = struct.unpack("<I", data[5:9])[0]
    pos = 9
    out = bytearray(out_size)
    if out_size == 0:
        return bytes(out)

    if order == 0:
        table, pos = _rans_read_freq_table(data, pos)
        sym_of, cum_of, freq_of = _rans_lookup(table)
        states = list(struct.unpack("<4I", data[pos:pos + 16])); pos += 16
        for i in range(out_size):
            j = i & 3
            x = states[j]
            m = x & (RANS_TOTFREQ - 1)
            s = int(sym_of[m])
            out[i] = s
            x = int(freq_of[m]) * (x >> RANS_TF_SHIFT) + m - int(cum_of[m])
            while x < (1 << 23):
                x = (x << 8) | data[pos]; pos += 1
            states[j] = x
        return bytes(out)

    if order == 1:
        # outer symbol list shares the RLE structure; each listed context has
        # its own inner table
        tables: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        ctx = data[pos]; pos += 1
        rle = 0
        while True:
            inner, pos = _rans_read_freq_table(data, pos)
            tables[ctx] = _rans_lookup(inner)
            if rle > 0:
                rle -= 1
                ctx += 1
            elif pos < len(data) and data[pos] == ctx + 1:
                ctx = data[pos]; pos += 1
                rle = data[pos]; pos += 1
            else:
                ctx = data[pos]; pos += 1
                if ctx == 0:
                    break
        states = list(struct.unpack("<4I", data[pos:pos + 16])); pos += 16
        quarter = out_size >> 2
        starts = [0, quarter, 2 * quarter, 3 * quarter]
        ends = [quarter, 2 * quarter, 3 * quarter, out_size]
        last = [0, 0, 0, 0]
        offsets = list(starts)
        # interleaved: advance all four streams in lockstep over the shortest
        # quarter, then stream 3 finishes the remainder
        for step in range(quarter):
            for j in range(4):
                x = states[j]
                m = x & (RANS_TOTFREQ - 1)
                sym_of, cum_of, freq_of = tables.get(last[j]) or tables[0]
                s = int(sym_of[m])
                out[offsets[j]] = s
                offsets[j] += 1
                x = int(freq_of[m]) * (x >> RANS_TF_SHIFT) + m - int(cum_of[m])
                while x < (1 << 23):
                    x = (x << 8) | data[pos]; pos += 1
                states[j] = x
                last[j] = s
        j = 3
        while offsets[j] < ends[j]:
            x = states[j]
            m = x & (RANS_TOTFREQ - 1)
            sym_of, cum_of, freq_of = tables.get(last[j]) or tables[0]
            s = int(sym_of[m])
            out[offsets[j]] = s
            offsets[j] += 1
            x = int(freq_of[m]) * (x >> RANS_TF_SHIFT) + m - int(cum_of[m])
            while x < (1 << 23):
                x = (x << 8) | data[pos]; pos += 1
            states[j] = x
            last[j] = s
        return bytes(out)

    raise NotImplementedError(f"rANS order {order} not supported")


# ---------------------------------------------------------------------------
# blocks

METHOD_RAW, METHOD_GZIP, METHOD_BZIP2, METHOD_LZMA, METHOD_RANS = 0, 1, 2, 3, 4
# CRAM 3.1 additions (decoders in cram31.py)
METHOD_RANS4X16, METHOD_ARITH, METHOD_FQZCOMP, METHOD_TOK3 = 5, 6, 7, 8
CT_FILE_HEADER, CT_COMPRESSION_HEADER, CT_SLICE_HEADER = 0, 1, 2
CT_EXTERNAL, CT_CORE = 4, 5


class Block:
    __slots__ = ("method", "content_type", "content_id", "data")

    def __init__(self, method: int, content_type: int, content_id: int, data: bytes):
        self.method = method
        self.content_type = content_type
        self.content_id = content_id
        self.data = data


def read_block(buf: io.BytesIO) -> Block:
    method = buf.read(1)[0]
    content_type = buf.read(1)[0]
    content_id = read_itf8(buf)
    compressed_size = read_itf8(buf)
    raw_size = read_itf8(buf)
    payload = buf.read(compressed_size)
    buf.read(4)  # CRC32
    if method == METHOD_RAW:
        data = payload
    elif method == METHOD_GZIP:
        data = zlib.decompress(payload, zlib.MAX_WBITS | 32)
    elif method == METHOD_BZIP2:
        data = bz2.decompress(payload)
    elif method == METHOD_LZMA:
        data = lzma.decompress(payload)
    elif method == METHOD_RANS:
        data = rans_decode(payload, raw_size)
    elif method == METHOD_RANS4X16:
        from .cram31 import rans4x16_decode
        data = rans4x16_decode(payload, raw_size)
    elif method == METHOD_ARITH:
        from .cram31 import arith_decode
        data = arith_decode(payload, raw_size)
    elif method == METHOD_TOK3:
        from .cram31 import tok3_decode_names
        data = tok3_decode_names(payload, raw_size)
    elif method == METHOD_FQZCOMP:
        from .cram31 import fqzcomp_decode
        try:
            data = fqzcomp_decode(payload, raw_size)
        except NotImplementedError as error:
            # qualities are unused by every pipeline stage (the reference
            # never inspects qual either); serve placeholder qualities
            # rather than failing the whole file on an unknown version
            import sys
            print(f"WARNING: CRAM 3.1 fqzcomp quality block skipped "
                  f"({error})", file=sys.stderr)
            data = bytes(raw_size)
    else:
        raise NotImplementedError(
            f"CRAM block compression method {method} not supported")
    if len(data) != raw_size:
        raise ValueError("CRAM block size mismatch")
    return Block(method, content_type, content_id, data)


def write_block(out: bytearray, content_type: int, content_id: int, data: bytes,
                method: int = METHOD_GZIP) -> None:
    if method == METHOD_GZIP:
        compressor = zlib.compressobj(6, zlib.DEFLATED, zlib.MAX_WBITS | 16)
        payload = compressor.compress(data) + compressor.flush()
    else:
        method = METHOD_RAW
        payload = data
    out += bytes([method, content_type])
    out += write_itf8(content_id)
    out += write_itf8(len(payload))
    out += write_itf8(len(data))
    out += payload
    out += struct.pack("<I", zlib.crc32(payload))


# ---------------------------------------------------------------------------
# codecs (decode side): each returns a callable over (core_bits, externals)

class BitReader:
    __slots__ = ("data", "pos", "bit")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 7

    def read_bit(self) -> int:
        value = (self.data[self.pos] >> self.bit) & 1
        if self.bit == 0:
            self.bit = 7
            self.pos += 1
        else:
            self.bit -= 1
        return value

    def read_bits(self, n: int) -> int:
        value = 0
        for _ in range(n):
            value = (value << 1) | self.read_bit()
        return value


class ExternalStream:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read_itf8(self) -> int:
        b0 = self.data[self.pos]; self.pos += 1
        if b0 < 0x80:
            value = b0
        elif b0 < 0xC0:
            value = ((b0 & 0x3F) << 8) | self.data[self.pos]; self.pos += 1
        elif b0 < 0xE0:
            value = ((b0 & 0x1F) << 16) | (self.data[self.pos] << 8) | self.data[self.pos + 1]
            self.pos += 2
        elif b0 < 0xF0:
            value = ((b0 & 0x0F) << 24) | (self.data[self.pos] << 16) \
                | (self.data[self.pos + 1] << 8) | self.data[self.pos + 2]
            self.pos += 3
        else:
            value = (((b0 & 0x0F) << 28) | (self.data[self.pos] << 20)
                     | (self.data[self.pos + 1] << 12) | (self.data[self.pos + 2] << 4)
                     | (self.data[self.pos + 3] & 0x0F))
            self.pos += 4
        if value >= 1 << 31:
            value -= 1 << 32
        return value

    def read_byte(self) -> int:
        value = self.data[self.pos]
        self.pos += 1
        return value

    def read_bytes(self, n: int) -> bytes:
        value = self.data[self.pos:self.pos + n]
        self.pos += n
        return value

    def read_until(self, stop: int) -> bytes:
        end = self.data.index(stop, self.pos)
        value = self.data[self.pos:end]
        self.pos = end + 1
        return value


CODEC_EXTERNAL, CODEC_HUFFMAN = 1, 3
CODEC_BYTE_ARRAY_LEN, CODEC_BYTE_ARRAY_STOP = 4, 5
CODEC_BETA, CODEC_SUBEXP, CODEC_GAMMA = 6, 7, 9


def parse_encoding(buf: io.BytesIO) -> Tuple[int, bytes]:
    codec = read_itf8(buf)
    n = read_itf8(buf)
    return codec, buf.read(n)


def make_int_decoder(codec: int, params: bytes):
    """Return f(bits, externals) -> int."""
    buf = io.BytesIO(params)
    if codec == CODEC_EXTERNAL:
        content_id = read_itf8(buf)
        return lambda bits, ext: ext[content_id].read_itf8()
    if codec == CODEC_HUFFMAN:
        n = read_itf8(buf)
        symbols = [read_itf8(buf) for _ in range(n)]
        n2 = read_itf8(buf)
        lengths = [read_itf8(buf) for _ in range(n2)]
        if all(length == 0 for length in lengths):
            value = symbols[0]
            return lambda bits, ext: value
        # canonical codes: sort by (length, symbol)
        order = sorted(range(n), key=lambda i: (lengths[i], symbols[i]))
        codes = {}
        code = 0
        prev_len = 0
        for i in order:
            code <<= (lengths[i] - prev_len)
            prev_len = lengths[i]
            codes[(lengths[i], code)] = symbols[i]
            code += 1

        def huffman(bits, ext):
            length = 0
            code = 0
            while True:
                code = (code << 1) | bits.read_bit()
                length += 1
                if (length, code) in codes:
                    return codes[(length, code)]
        return huffman
    if codec == CODEC_BETA:
        offset = read_itf8(buf)
        n_bits = read_itf8(buf)
        return lambda bits, ext: bits.read_bits(n_bits) - offset
    if codec == CODEC_GAMMA:
        offset = read_itf8(buf)

        def gamma(bits, ext):
            n = 1
            while bits.read_bit() == 0:
                n += 1
            value = 1
            for _ in range(n - 1):
                value = (value << 1) | bits.read_bit()
            return value - offset
        return gamma
    if codec == CODEC_SUBEXP:
        offset = read_itf8(buf)
        k = read_itf8(buf)

        def subexp(bits, ext):
            i = 0
            while bits.read_bit():
                i += 1
            if i == 0:
                value = bits.read_bits(k)
            else:
                value = bits.read_bits(i + k - 1) + (1 << (i + k - 1))
            return value - offset
        return subexp
    raise NotImplementedError(f"CRAM integer codec {codec} not supported")


def make_byte_decoder(codec: int, params: bytes):
    """Return f(bits, externals) -> bytes (arrays) or int (single byte)."""
    buf = io.BytesIO(params)
    if codec == CODEC_EXTERNAL:
        content_id = read_itf8(buf)
        return ("byte", lambda bits, ext: ext[content_id].read_byte())
    if codec == CODEC_HUFFMAN:
        decoder = make_int_decoder(codec, params)
        return ("byte", decoder)
    if codec == CODEC_BYTE_ARRAY_LEN:
        len_codec, len_params = parse_encoding(buf)
        val_codec, val_params = parse_encoding(buf)
        len_decoder = make_int_decoder(len_codec, len_params)
        val_buf = io.BytesIO(val_params)
        if val_codec != CODEC_EXTERNAL:
            raise NotImplementedError("BYTE_ARRAY_LEN values must be EXTERNAL")
        val_id = read_itf8(val_buf)

        def array_len(bits, ext):
            n = len_decoder(bits, ext)
            return ext[val_id].read_bytes(n)
        return ("array", array_len)
    if codec == CODEC_BYTE_ARRAY_STOP:
        stop = buf.read(1)[0]
        content_id = read_itf8(buf)
        return ("array", lambda bits, ext: ext[content_id].read_until(stop))
    raise NotImplementedError(f"CRAM byte codec {codec} not supported")


# ---------------------------------------------------------------------------
# compression header

class CompressionHeader:
    def __init__(self) -> None:
        self.read_names_included = True
        self.ap_delta = False
        self.reference_required = True
        self.substitution_matrix: List[bytes] = [b"ACGTN"] * 5
        self.tag_lines: List[List[Tuple[str, str]]] = []
        self.int_decoders: Dict[str, Callable] = {}
        self.byte_decoders: Dict[str, Tuple[str, Callable]] = {}
        self.tag_decoders: Dict[int, Tuple[str, Callable]] = {}


BASES = b"ACGTN"


def parse_compression_header(data: bytes) -> CompressionHeader:
    buf = io.BytesIO(data)
    header = CompressionHeader()

    # preservation map
    read_itf8(buf)  # size in bytes
    n = read_itf8(buf)
    for _ in range(n):
        key = buf.read(2).decode("ascii")
        if key == "RN":
            header.read_names_included = buf.read(1)[0] != 0
        elif key == "AP":
            header.ap_delta = buf.read(1)[0] != 0
        elif key == "RR":
            header.reference_required = buf.read(1)[0] != 0
        elif key == "SM":
            matrix_bytes = buf.read(5)
            header.substitution_matrix = []
            for i in range(5):
                row = bytearray(4)
                k = 0
                for j in range(5):
                    if i == j:
                        continue
                    code = (matrix_bytes[i] >> (6 - 2 * k)) & 3
                    row[code] = BASES[j]
                    k += 1
                header.substitution_matrix.append(bytes(row))
        elif key == "TD":
            size = read_itf8(buf)
            blob = buf.read(size)
            for line in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00"):
                tags = []
                for i in range(0, len(line), 3):
                    tags.append((line[i:i + 2].decode("ascii"),
                                 chr(line[i + 2])))
                header.tag_lines.append(tags)
        else:
            raise NotImplementedError(f"CRAM preservation key {key}")

    # data series encodings
    read_itf8(buf)
    n = read_itf8(buf)
    byte_series = {"BA", "QS", "FC", "FN"}  # FN is int; FC is byte
    array_series = {"RN", "BB", "QQ", "IN", "SC"}
    for _ in range(n):
        key = buf.read(2).decode("ascii")
        codec, params = parse_encoding(buf)
        if key in array_series or key in ("BA", "QS", "FC"):
            header.byte_decoders[key] = make_byte_decoder(codec, params)
        else:
            header.int_decoders[key] = make_int_decoder(codec, params)

    # tag encodings
    read_itf8(buf)
    n = read_itf8(buf)
    for _ in range(n):
        key = read_itf8(buf)
        codec, params = parse_encoding(buf)
        header.tag_decoders[key] = make_byte_decoder(codec, params)
    return header


# ---------------------------------------------------------------------------
# record decoding

class CramRecord:
    __slots__ = ("bam_flags", "cram_flags", "ref_id", "read_length", "position",
                 "read_group", "read_name", "mate_flags", "mate_ref_id",
                 "mate_position", "template_size", "next_fragment", "tags",
                 "mapping_quality", "features", "bases", "quals")

    def __init__(self) -> None:
        self.next_fragment = -1
        self.features: List[Tuple[str, int, object]] = []
        self.bases = b""
        self.quals = b""
        self.mate_flags = 0
        self.mate_ref_id = -1
        self.mate_position = -1
        self.template_size = 0
        self.read_name = b""
        self.tags = []


def decode_slice_records(compression: CompressionHeader, n_records: int,
                         slice_ref_id: int, slice_start: int,
                         core: BitReader, externals: Dict[int, ExternalStream],
                         counter_base: int) -> List[CramRecord]:
    ints = compression.int_decoders
    bytes_dec = compression.byte_decoders
    records = []
    last_position = slice_start

    def read_int(key: str) -> int:
        return ints[key](core, externals)

    def read_byte(key: str) -> int:
        kind, decoder = bytes_dec[key]
        return decoder(core, externals)

    for i in range(n_records):
        rec = CramRecord()
        rec.bam_flags = read_int("BF")
        rec.cram_flags = read_int("CF")
        if slice_ref_id == -2:
            rec.ref_id = read_int("RI")
        else:
            rec.ref_id = slice_ref_id
        rec.read_length = read_int("RL")
        if compression.ap_delta:
            last_position += read_int("AP")
            rec.position = last_position
        else:
            rec.position = read_int("AP")
        rec.read_group = read_int("RG") if "RG" in ints else -1

        if compression.read_names_included:
            kind, decoder = bytes_dec["RN"]
            rec.read_name = decoder(core, externals)

        if rec.cram_flags & 0x2:  # detached
            rec.mate_flags = read_int("MF")
            if not compression.read_names_included:
                kind, decoder = bytes_dec["RN"]
                rec.read_name = decoder(core, externals)
            rec.mate_ref_id = read_int("NS")
            rec.mate_position = read_int("NP")
            rec.template_size = read_int("TS")
        elif rec.cram_flags & 0x4:  # mate downstream
            rec.next_fragment = read_int("NF")

        tag_line = read_int("TL")
        if 0 <= tag_line < len(compression.tag_lines):
            for tag, tag_type in compression.tag_lines[tag_line]:
                key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(tag_type)
                kind, decoder = compression.tag_decoders[key]
                raw = decoder(core, externals)
                if kind == "byte":
                    raw = bytes([raw])
                rec.tags.append((tag, tag_type, bytes(raw)))

        if not (rec.bam_flags & 0x4):  # mapped
            n_features = read_int("FN")
            position = 0
            for _ in range(n_features):
                kind, decoder = bytes_dec["FC"]
                code = chr(decoder(core, externals))
                position += read_int("FP")
                if code == "X":
                    rec.features.append((code, position, read_int("BS")))
                elif code == "S":
                    kind, dec = bytes_dec["SC"]
                    rec.features.append((code, position, dec(core, externals)))
                elif code == "I":
                    kind, dec = bytes_dec["IN"]
                    rec.features.append((code, position, dec(core, externals)))
                elif code == "i":
                    kind, dec = bytes_dec["BA"]
                    rec.features.append((code, position, dec(core, externals)))
                elif code == "D":
                    rec.features.append((code, position, read_int("DL")))
                elif code == "N":
                    rec.features.append((code, position, read_int("RS")))
                elif code == "P":
                    rec.features.append((code, position, read_int("PD")))
                elif code == "H":
                    rec.features.append((code, position, read_int("HC")))
                elif code == "B":
                    kind, dec = bytes_dec["BA"]
                    base = dec(core, externals)
                    kind2, dec2 = bytes_dec["QS"]
                    dec2(core, externals)
                    rec.features.append(("i", position, base))
                elif code == "b":
                    kind, dec = bytes_dec["BB"]
                    rec.features.append((code, position, dec(core, externals)))
                elif code == "q":
                    kind, dec = bytes_dec["QQ"]
                    dec(core, externals)
                elif code == "Q":
                    kind, dec = bytes_dec["QS"]
                    dec(core, externals)
                else:
                    raise NotImplementedError(f"CRAM feature code {code}")
            rec.mapping_quality = read_int("MQ")
            if rec.cram_flags & 0x1:
                kind, dec = bytes_dec["QS"]
                rec.quals = bytes(dec(core, externals) for _ in range(rec.read_length))
        else:  # unmapped: bases stored verbatim
            kind, dec = bytes_dec["BA"]
            rec.bases = bytes(dec(core, externals) for _ in range(rec.read_length))
            rec.mapping_quality = 0
            if rec.cram_flags & 0x1:
                kind, dec = bytes_dec["QS"]
                rec.quals = bytes(dec(core, externals) for _ in range(rec.read_length))

        if not rec.read_name:
            rec.read_name = b"%d" % (counter_base + i)
        records.append(rec)
    return records


def reconstruct_alignment(rec: CramRecord, compression: CompressionHeader,
                          reference: Optional[np.ndarray]) -> Tuple[bytes, List[int]]:
    """Rebuild (sequence, cigar) from features + the reference substring."""
    if rec.bam_flags & 0x4:
        return rec.bases, []

    seq = bytearray(rec.read_length)
    cigar: List[Tuple[str, int]] = []
    read_pos = 0          # 0-based position in the read
    ref_pos = rec.position - 1  # 0-based reference position

    def ref_bases(start: int, n: int) -> bytes:
        if reference is None or n <= 0:
            return b"N" * max(n, 0)
        end = min(start + n, len(reference))
        chunk = reference[start:end].tobytes() if start < len(reference) else b""
        return chunk + b"N" * (n - len(chunk))

    def add_cigar(op: str, n: int) -> None:
        if n <= 0:
            return
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + n)
        else:
            cigar.append((op, n))

    sub_matrix = compression.substitution_matrix

    for code, position, value in rec.features:
        gap = (position - 1) - read_pos  # match bases before this feature
        if gap > 0:
            seq[read_pos:read_pos + gap] = ref_bases(ref_pos, gap)
            add_cigar("M", gap)
            read_pos += gap
            ref_pos += gap
        if code == "X":
            ref_base = ref_bases(ref_pos, 1)
            base_index = BASES.find(ref_base[0:1].upper() or b"N")
            if base_index < 0:
                base_index = 4
            seq[read_pos] = sub_matrix[base_index][value]
            add_cigar("M", 1)
            read_pos += 1
            ref_pos += 1
        elif code == "S":
            seq[read_pos:read_pos + len(value)] = value
            add_cigar("S", len(value))
            read_pos += len(value)
        elif code == "I":
            seq[read_pos:read_pos + len(value)] = value
            add_cigar("I", len(value))
            read_pos += len(value)
        elif code == "i":
            seq[read_pos] = value
            add_cigar("I", 1)
            read_pos += 1
        elif code == "D":
            add_cigar("D", value)
            ref_pos += value
        elif code == "N":
            add_cigar("N", value)
            ref_pos += value
        elif code == "P":
            add_cigar("P", value)
        elif code == "H":
            add_cigar("H", value)
        elif code == "b":
            seq[read_pos:read_pos + len(value)] = value
            add_cigar("M", len(value))
            read_pos += len(value)
            ref_pos += len(value)

    tail = rec.read_length - read_pos
    if tail > 0:
        seq[read_pos:read_pos + tail] = ref_bases(ref_pos, tail)
        add_cigar("M", tail)

    ops = "MIDNSHP=X"
    cigar_words = [make_cigar_word(ops.index(op), n) for op, n in cigar]
    return bytes(seq), cigar_words


# ---------------------------------------------------------------------------
# reader

def read_cram(path: str, reference_by_name: Optional[Dict[str, np.ndarray]] = None):
    """Returns (SamHeader, iterator of BamRecord) like read_bam/read_sam_text."""
    from .bam import BamRecord, SamHeader

    with open(path, "rb") as fh:
        raw = fh.read()
    buf = io.BytesIO(raw)
    magic = buf.read(4)
    if magic != b"CRAM":
        raise ValueError("not a CRAM file")
    major, minor = buf.read(1)[0], buf.read(1)[0]
    if major not in (2, 3):
        raise NotImplementedError(f"CRAM version {major}.{minor} not supported")
    buf.read(20)  # file id

    def read_container_header():
        length_bytes = buf.read(4)
        if len(length_bytes) < 4:
            return None
        length = struct.unpack("<i", length_bytes)[0]
        ref_id = read_itf8(buf)
        start = read_itf8(buf)
        span = read_itf8(buf)
        n_records = read_itf8(buf)
        counter = read_ltf8(buf) if major >= 3 else read_itf8(buf)
        read_ltf8(buf) if major >= 3 else read_itf8(buf)  # bases
        n_blocks = read_itf8(buf)
        n_landmarks = read_itf8(buf)
        for _ in range(n_landmarks):
            read_itf8(buf)
        if major >= 3:
            buf.read(4)  # CRC32
        return length, ref_id, start, span, n_records, counter, n_blocks

    # first container: SAM header text
    container = read_container_header()
    if container is None:
        raise ValueError("truncated CRAM file")
    header_block = read_block(buf)
    text_length = struct.unpack("<i", header_block.data[:4])[0]
    header_text = header_block.data[4:4 + text_length].decode("latin-1")
    # consume remaining blocks of the header container
    for _ in range(container[6] - 1):
        read_block(buf)

    header = SamHeader()
    header.text = header_text
    for line in header_text.splitlines():
        if line.startswith("@SQ"):
            name = length = None
            for field in line.split("\t")[1:]:
                if field.startswith("SN:"):
                    name = field[3:]
                elif field.startswith("LN:"):
                    length = int(field[3:])
            if name is not None:
                header.target_names.append(name)
                header.target_lengths.append(length or 0)

    references: List[Optional[np.ndarray]] = []
    for name in header.target_names:
        ref = (reference_by_name or {}).get(name)
        references.append(ref)

    def records() -> Iterator[BamRecord]:
        while True:
            container = read_container_header()
            if container is None:
                return
            length, c_ref_id, c_start, c_span, c_records, counter, n_blocks = container
            container_end = buf.tell() + length
            if c_records == 0:  # EOF container (or an empty one)
                buf.seek(container_end)
                if c_ref_id == -1 and c_start == 4542278:
                    return  # spec EOF marker
                continue
            compression = parse_compression_header(read_block(buf).data)
            blocks_read = 1
            while blocks_read < n_blocks:
                slice_header_block = read_block(buf)
                blocks_read += 1
                if slice_header_block.content_type != CT_SLICE_HEADER:
                    continue
                sbuf = io.BytesIO(slice_header_block.data)
                s_ref_id = read_itf8(sbuf)
                s_start = read_itf8(sbuf)
                read_itf8(sbuf)  # span
                s_records = read_itf8(sbuf)
                s_counter = read_ltf8(sbuf) if major >= 3 else read_itf8(sbuf)
                s_blocks = read_itf8(sbuf)
                content_ids = [read_itf8(sbuf) for _ in range(read_itf8(sbuf))]
                read_itf8(sbuf)  # embedded reference content id
                # 16-byte MD5 + optional tags ignored

                core_data = b""
                externals: Dict[int, ExternalStream] = {}
                for _ in range(s_blocks):
                    block = read_block(buf)
                    blocks_read += 1
                    if block.content_type == CT_CORE:
                        core_data = block.data
                    elif block.content_type == CT_EXTERNAL:
                        externals[block.content_id] = ExternalStream(block.data)
                core = BitReader(core_data)

                cram_records = decode_slice_records(
                    compression, s_records, s_ref_id, s_start, core, externals,
                    s_counter)

                # mate resolution + BamRecord construction
                for i, rec in enumerate(cram_records):
                    flags = rec.bam_flags
                    mtid, mpos, tlen = -1, -1, 0
                    if rec.cram_flags & 0x2:  # detached
                        if rec.mate_flags & 0x1:
                            flags |= 0x20  # mate reverse strand
                        if rec.mate_flags & 0x2:
                            flags |= 0x8   # mate unmapped
                        mtid = rec.mate_ref_id
                        mpos = rec.mate_position - 1
                        tlen = rec.template_size
                    elif rec.next_fragment >= 0:
                        mate = cram_records[i + rec.next_fragment + 1]
                        mtid = mate.ref_id
                        mpos = mate.position - 1
                        if mate.bam_flags & 0x10:
                            flags |= 0x20
                        if mate.bam_flags & 0x4:
                            flags |= 0x8
                        mate.bam_flags |= (0x20 if flags & 0x10 else 0) | \
                                          (0x8 if flags & 0x4 else 0)
                        mate.mate_ref_id = rec.ref_id
                        mate.mate_position = rec.position
                        mate.cram_flags |= 0x2  # treat as resolved downstream
                        leftmost = min(rec.position, mate.position)
                        rightmost = max(rec.position + rec.read_length,
                                        mate.position + mate.read_length)
                        tlen = rightmost - leftmost
                        mate.template_size = -tlen
                        mate.mate_flags = 0
                    elif rec.mate_ref_id >= 0 or rec.mate_position >= 0:
                        mtid = rec.mate_ref_id
                        mpos = rec.mate_position - 1
                        tlen = rec.template_size

                    reference = (references[rec.ref_id]
                                 if 0 <= rec.ref_id < len(references) else None)
                    seq, cigar_words = reconstruct_alignment(rec, compression,
                                                             reference)
                    tags = {}
                    for tag, tag_type, raw in rec.tags:
                        tags[tag] = _parse_tag_value(tag_type, raw)

                    record = BamRecord(
                        qname=rec.read_name.decode("latin-1"),
                        flag=flags, tid=rec.ref_id, pos=rec.position - 1,
                        mapq=rec.mapping_quality,
                        cigar=np.array(cigar_words, np.uint32),
                        mtid=mtid, mpos=mpos, tlen=tlen,
                        seq=seq.decode("latin-1"),
                        qual="".join(chr(q + 33) for q in rec.quals) if rec.quals else "")
                    record.tags.update(tags)
                    yield record
            buf.seek(container_end)

    return header, records()


def _parse_tag_value(tag_type: str, raw: bytes):
    if tag_type == "i":
        return struct.unpack("<i", raw)[0]
    if tag_type == "I":
        return struct.unpack("<I", raw)[0]
    if tag_type == "s":
        return struct.unpack("<h", raw)[0]
    if tag_type == "S":
        return struct.unpack("<H", raw)[0]
    if tag_type == "c":
        return struct.unpack("<b", raw)[0]
    if tag_type == "C":
        return struct.unpack("<B", raw)[0]
    if tag_type == "f":
        return struct.unpack("<f", raw)[0]
    if tag_type == "A":
        return raw.decode("latin-1")
    if tag_type in ("Z", "H"):
        return raw.rstrip(b"\x00").decode("latin-1")
    return raw


# ---------------------------------------------------------------------------
# writer (tests + interoperability fixtures)

def _encode_tag_value(tag_type: str, value) -> bytes:
    if tag_type == "i":
        return struct.pack("<i", value)
    if tag_type == "f":
        return struct.pack("<f", value)
    if tag_type == "A":
        return value.encode("latin-1")
    if tag_type == "Z":
        return value.encode("latin-1") + b"\x00"
    raise NotImplementedError(f"tag type {tag_type}")


def write_cram(path: str, header, records,
               reference_by_name: Dict[str, np.ndarray],
               mate_downstream: bool = False) -> None:
    """Minimal CRAM 3.0 writer: one slice per container, gzip-compressed
    EXTERNAL/BYTE_ARRAY_STOP encodings, reference-based sequences with the
    identity substitution matrix. Records are written detached by default;
    with `mate_downstream`, adjacent same-name paired records are linked via
    the NF data series instead (exercising the reader's downstream-mate
    resolution, the form htslib emits for sorted pairs)."""
    out = bytearray()
    out += b"CRAM" + bytes([3, 0]) + b"arriba_tpu_cram_fix\x00"

    header_text = "@HD\tVN:1.6\tSO:unsorted\n"
    for name, length in zip(header.target_names, header.target_lengths):
        header_text += f"@SQ\tSN:{name}\tLN:{length}\n"
    header_payload = struct.pack("<i", len(header_text)) + header_text.encode()

    def container(blocks_payload: bytes, ref_id: int, start: int, span: int,
                  n_records: int, n_blocks: int, landmarks: List[int]) -> bytes:
        head = bytearray()
        head += struct.pack("<i", len(blocks_payload))
        head += write_itf8(ref_id)
        head += write_itf8(start)
        head += write_itf8(span)
        head += write_itf8(n_records)
        head += write_ltf8(0)   # record counter
        head += write_ltf8(0)   # bases
        head += write_itf8(n_blocks)
        head += write_itf8(len(landmarks))
        for landmark in landmarks:
            head += write_itf8(landmark)
        head += struct.pack("<I", zlib.crc32(bytes(head)))
        return bytes(head) + blocks_payload

    block0 = bytearray()
    write_block(block0, CT_FILE_HEADER, 0, header_payload, METHOD_RAW)
    out += container(bytes(block0), -1, 0, 0, 0, 1, [0])

    references = [reference_by_name.get(name) for name in header.target_names]

    # external content ids (one stream per series)
    ids = {key: idx + 1 for idx, key in enumerate(
        ["BF", "CF", "RI", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS",
         "NF", "TL", "FN", "FC", "FP", "BS", "IN", "SC", "DL", "RS", "PD",
         "HC", "MQ", "BA", "QS", "TAG"])}

    # group records into one slice
    streams: Dict[str, bytearray] = {key: bytearray() for key in ids}

    def put_int(key: str, value: int) -> None:
        streams[key] += write_itf8(value)

    # collect distinct tag lines
    tag_lines: List[Tuple[Tuple[str, str], ...]] = []
    record_list = list(records)
    for rec in record_list:
        line = tuple((name, _tag_type_of(value)) for name, value in rec.tags.items())
        if line not in tag_lines:
            tag_lines.append(line)

    for index, rec in enumerate(record_list):
        downstream = (mate_downstream and index + 1 < len(record_list)
                      and (rec.flag & 0x1)
                      and record_list[index + 1].qname == rec.qname)
        put_int("BF", rec.flag & ~0x28)          # mate bits via MF/mate record
        cram_flags = 0x1 if rec.qual else 0
        cram_flags |= 0x4 if downstream else 0x2
        put_int("CF", cram_flags)
        put_int("RI", rec.tid)
        put_int("RL", len(rec.seq))
        put_int("AP", rec.pos + 1)
        put_int("RG", -1)
        streams["RN"] += rec.qname.encode("latin-1") + b"\x00"
        if downstream:
            put_int("NF", 0)  # the mate is the next record in the slice
        else:
            put_int("MF", (0x1 if rec.flag & 0x20 else 0) | (0x2 if rec.flag & 0x8 else 0))
            put_int("NS", rec.mtid)
            put_int("NP", rec.mpos + 1)
            put_int("TS", rec.tlen)
        line = tuple((name, _tag_type_of(value)) for name, value in rec.tags.items())
        put_int("TL", tag_lines.index(line))
        for name, value in rec.tags.items():
            tag_type = _tag_type_of(value)
            raw = _encode_tag_value(tag_type, value)
            streams["TAG"] += write_itf8(len(raw)) + raw

        if not (rec.flag & 0x4):
            features = _features_of(rec, references[rec.tid] if rec.tid >= 0 else None)
            put_int("FN", len(features))
            last = 0
            for code, position, value in features:
                streams["FC"] += code.encode()
                put_int("FP", position - last)
                last = position
                if code == "X":
                    put_int("BS", value)
                elif code == "S":
                    streams["SC"] += value + b"\x00"
                elif code == "I":
                    streams["IN"] += value + b"\x00"
                elif code == "D":
                    put_int("DL", value)
                elif code == "N":
                    put_int("RS", value)
                elif code == "H":
                    put_int("HC", value)
                elif code == "P":
                    put_int("PD", value)
            put_int("MQ", rec.mapq)
            if rec.qual:
                streams["QS"] += bytes(ord(c) - 33 for c in rec.qual)
        else:
            streams["BA"] += rec.seq.encode("latin-1")
            if rec.qual:
                streams["QS"] += bytes(ord(c) - 33 for c in rec.qual)

    # compression header
    ch = bytearray()
    pres = bytearray()
    pres_entries = bytearray()
    n_pres = 0
    for key, value in (("RN", 1), ("AP", 0), ("RR", 1)):
        pres_entries += key.encode() + bytes([value])
        n_pres += 1
    pres_entries += b"SM" + bytes([0x1B] * 5)
    n_pres += 1
    td_blob = bytearray()
    for line in tag_lines:
        for name, tag_type in line:
            td_blob += name.encode() + tag_type.encode()
        td_blob += b"\x00"
    pres_entries += b"TD" + write_itf8(len(td_blob)) + td_blob
    n_pres += 1
    pres += write_itf8(n_pres) + pres_entries
    ch += write_itf8(len(pres)) + pres

    def external_encoding(content_id: int) -> bytes:
        params = write_itf8(content_id)
        return write_itf8(CODEC_EXTERNAL) + write_itf8(len(params)) + params

    def stop_encoding(content_id: int) -> bytes:
        params = bytes([0]) + write_itf8(content_id)
        return write_itf8(CODEC_BYTE_ARRAY_STOP) + write_itf8(len(params)) + params

    ds = bytearray()
    ds_entries = bytearray()
    n_ds = 0
    for key in ["BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS",
                "NF", "TL", "FN", "FP", "BS", "DL", "RS", "PD", "HC", "MQ"]:
        ds_entries += key.encode() + external_encoding(ids[key])
        n_ds += 1
    ds_entries += b"RN" + stop_encoding(ids["RN"]); n_ds += 1
    ds_entries += b"SC" + stop_encoding(ids["SC"]); n_ds += 1
    ds_entries += b"IN" + stop_encoding(ids["IN"]); n_ds += 1
    ds_entries += b"FC" + external_encoding(ids["FC"]); n_ds += 1
    ds_entries += b"BA" + external_encoding(ids["BA"]); n_ds += 1
    ds_entries += b"QS" + external_encoding(ids["QS"]); n_ds += 1
    ds += write_itf8(n_ds) + ds_entries
    ch += write_itf8(len(ds)) + ds

    tag_map = bytearray()
    tag_entries = bytearray()
    seen_tags = set()
    n_tags = 0
    for line in tag_lines:
        for name, tag_type in line:
            key = (ord(name[0]) << 16) | (ord(name[1]) << 8) | ord(tag_type)
            if key in seen_tags:
                continue
            seen_tags.add(key)
            len_params = write_itf8(ids["TAG"])
            len_enc = write_itf8(CODEC_EXTERNAL) + write_itf8(len(len_params)) + len_params
            val_enc = write_itf8(CODEC_EXTERNAL) + write_itf8(len(len_params)) + len_params
            params = len_enc + val_enc
            tag_entries += write_itf8(key)
            tag_entries += write_itf8(CODEC_BYTE_ARRAY_LEN) + write_itf8(len(params)) + params
            n_tags += 1
    tag_map += write_itf8(n_tags) + tag_entries
    ch += write_itf8(len(tag_map)) + tag_map

    # slice header
    used_ids = [ids[key] for key in ids if len(streams[key])]
    sh = bytearray()
    sh += write_itf8(-2)  # multiref
    sh += write_itf8(0)
    sh += write_itf8(0)
    sh += write_itf8(len(record_list))
    sh += write_ltf8(0)
    sh += write_itf8(len(used_ids) + 1)  # core + externals
    sh += write_itf8(len(used_ids))
    for content_id in used_ids:
        sh += write_itf8(content_id)
    sh += write_itf8(-1)  # no embedded reference
    sh += b"\x00" * 16    # MD5

    blocks = bytearray()
    write_block(blocks, CT_COMPRESSION_HEADER, 0, bytes(ch))
    landmark = len(blocks)
    write_block(blocks, CT_SLICE_HEADER, 0, bytes(sh))
    write_block(blocks, CT_CORE, 0, b"")
    for key in ids:
        if len(streams[key]):
            write_block(blocks, CT_EXTERNAL, ids[key], bytes(streams[key]))

    out += container(bytes(blocks), -2, 0, 0, len(record_list),
                     3 + len(used_ids), [landmark])

    # EOF container: ref id -1, start 4542278 (the spec marker), one empty
    # compression-header block
    eof_block = bytearray()
    write_block(eof_block, CT_COMPRESSION_HEADER, 0, b"\x01\x00\x01\x00\x01\x00",
                METHOD_RAW)
    out += container(bytes(eof_block), -1, 4542278, 0, 0, 1, [0])

    with open(path, "wb") as fh:
        fh.write(out)


def _tag_type_of(value) -> str:
    if isinstance(value, int):
        return "i"
    if isinstance(value, float):
        return "f"
    if isinstance(value, str) and len(value) == 1:
        return "A"
    return "Z"


def _features_of(rec, reference: Optional[np.ndarray]):
    """Derive CRAM features from a record's CIGAR + sequence vs reference."""
    features = []
    read_pos = 0
    ref_pos = rec.pos
    seq = rec.seq.encode("latin-1")
    for word in rec.cigar.tolist():
        op = word & 0xF
        oplen = word >> 4
        if op in (0, 7, 8):  # M/=/X: emit substitutions
            for j in range(oplen):
                ref_base = (reference[ref_pos + j]
                            if reference is not None and ref_pos + j < len(reference)
                            else ord("N"))
                read_base = seq[read_pos + j]
                if read_base != ref_base:
                    base_index = BASES.find(bytes([ref_base]))
                    if base_index < 0:
                        base_index = 4
                    alternatives = [b for b in BASES if b != BASES[base_index]]
                    code = alternatives.index(read_base) if read_base in alternatives else 0
                    features.append(("X", read_pos + j + 1, code))
            read_pos += oplen
            ref_pos += oplen
        elif op == 1:  # I
            features.append(("I", read_pos + 1, seq[read_pos:read_pos + oplen]))
            read_pos += oplen
        elif op == 2:  # D
            features.append(("D", read_pos + 1, oplen))
            ref_pos += oplen
        elif op == 3:  # N
            features.append(("N", read_pos + 1, oplen))
            ref_pos += oplen
        elif op == 4:  # S
            features.append(("S", read_pos + 1, seq[read_pos:read_pos + oplen]))
            read_pos += oplen
        elif op == 5:  # H
            features.append(("H", read_pos + 1, oplen))
        elif op == 6:  # P
            features.append(("P", read_pos + 1, oplen))
    return features
