"""CRAM 3.1 block codecs (clean-room, from the published CRAM codecs spec).

CRAM 3.1 keeps the 3.0 container/slice/record layout (io/cram.py) and adds
four block compression methods:

- method 5, rANS Nx16 ("rans4x16pr"): order-0/1 range-asymmetric-numeral-
  system coder with 16-bit renormalization and 4- or 32-way interleaved
  states, wrapped in a transform container (bit-PACK, RLE, STRIPE, CAT).
- method 6, adaptive arithmetic coder: byte-wise adaptive range coder
  (order 0/1) in the same transform container (EXT = bzip2 passthrough).
- method 7, fqzcomp: context-modelled quality coder.
- method 8, name tokeniser ("tok3"): column-wise token decomposition of
  read names over rans4x16/arith-compressed token streams.

The reference delegates all of this to htslib (the reference's Makefile
builds htslib 1.22.1); this is an independent implementation of the spec.
Bit-level interop with htslib-written files cannot be exercised in this
environment (no htslib, no network); the test strategy is the same as for
the 3.0 rANS-4x8 codec: a test-local encoder that is the exact structural
inverse of this decoder (tests/test_cram31_codecs.py), plus decode-path
fuzzing. Layout choices below cite the spec section they implement.
"""

from __future__ import annotations

import bz2
from typing import List, Optional, Tuple

from .._native_build import engine

__all__ = [
    "rans4x16_decode",
    "arith_decode",
    "tok3_decode_names",
    "fqzcomp_decode",
]


# ---------------------------------------------------------------------------
# shared primitives

class ByteStream:
    """Positional reader over a bytes-like object."""

    __slots__ = ("data", "pos")

    def __init__(self, data, pos: int = 0):
        self.data = data
        self.pos = pos

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def read(self, n: int) -> bytes:
        out = bytes(self.data[self.pos:self.pos + n])
        if len(out) != n:
            raise ValueError("CRAM 3.1 codec: truncated stream")
        self.pos += n
        return out

    def uint7(self) -> int:
        """Big-endian base-128 varint (spec: ReadUint7)."""
        value = 0
        while True:
            c = self.byte()
            value = (value << 7) | (c & 0x7F)
            if not (c & 0x80):
                return value

    def uint16le(self) -> int:
        v = self.data[self.pos] | (self.data[self.pos + 1] << 8)
        self.pos += 2
        return v

    def uint32le(self) -> int:
        d, p = self.data, self.pos
        self.pos += 4
        return d[p] | (d[p + 1] << 8) | (d[p + 2] << 16) | (d[p + 3] << 24)

    def exhausted(self) -> bool:
        return self.pos >= len(self.data)


# rans4x16 / arith container transform flags (spec: rANS Nx16 "Order" byte)
F_ORDER1 = 0x01
F_X32 = 0x04      # rans4x16: 32 interleaved states; arith: EXT (bzip2)
F_EXT = 0x04
F_STRIPE = 0x08
F_NOSZ = 0x10
F_CAT = 0x20
F_RLE = 0x40
F_PACK = 0x80


def _normalise_freqs(freqs: List[int], total_to: int) -> None:
    """Scale a frequency table so it sums to total_to, minimum 1 per used
    symbol, remainder granted to the most frequent symbol (the spec's
    NormaliseFrequencies; integer arithmetic exactly as published so the
    encoder and decoder agree bit-for-bit)."""
    tot = sum(freqs)
    if tot == 0 or tot == total_to:
        return
    tr = ((total_to << 31) // tot) + ((1 << 30) // tot)
    new_tot = 0
    max_val = 0
    max_sym = 0
    for j in range(256):
        if not freqs[j]:
            continue
        if max_val < freqs[j]:
            max_val = freqs[j]
            max_sym = j
        scaled = (freqs[j] * tr) >> 31
        if scaled == 0:
            scaled = 1
        freqs[j] = scaled
        new_tot += scaled
    freqs[max_sym] += total_to - new_tot


def _read_alphabet(src: ByteStream) -> List[int]:
    """Symbol list with run-length encoding of consecutive values (spec:
    ReadAlphabet; runs are flagged by a symbol equal to last+1)."""
    alphabet = []
    rle = 0
    sym = src.byte()
    while True:
        alphabet.append(sym)
        last_sym = sym
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            sym = src.byte()
            if sym == last_sym + 1:
                rle = src.byte()
        if sym == 0:
            break
    return alphabet


# ---------------------------------------------------------------------------
# rANS Nx16 (method 5)

_RANS_NX16_LOWER = 1 << 15   # 16-bit renormalization lower bound


def _rans_nx16_decode_o0(src: ByteStream, out_len: int, n_states: int) -> bytearray:
    """Order-0 Nx16 decode: frequencies normalized to 2^12."""
    alphabet = _read_alphabet(src)
    freqs = [0] * 256
    for s in alphabet:
        freqs[s] = src.uint7()
    _normalise_freqs(freqs, 1 << 12)

    # dense lookup over the 4096 slots
    sym_of = bytearray(1 << 12)
    cum_of = [0] * 256
    cum = 0
    for s in range(256):
        if freqs[s]:
            cum_of[s] = cum
            for k in range(cum, cum + freqs[s]):
                sym_of[k] = s
            cum += freqs[s]

    states = [src.uint32le() for _ in range(n_states)]
    out = bytearray(out_len)
    mask = (1 << 12) - 1
    for i in range(out_len):
        j = i % n_states
        x = states[j]
        m = x & mask
        s = sym_of[m]
        out[i] = s
        x = freqs[s] * (x >> 12) + m - cum_of[s]
        while x < _RANS_NX16_LOWER:
            x = (x << 16) | src.uint16le()
        states[j] = x
    return out


def _rans_nx16_decode_o1(src: ByteStream, out_len: int, n_states: int) -> bytearray:
    """Order-1 Nx16 decode: per-context tables normalized to 2^shift; the
    output is split into n_states contiguous segments, the last state
    finishing the remainder; every segment starts with context 0."""
    comp = src.byte()
    shift = comp >> 4
    if comp & 1:
        # compressed table: a RAW order-0 4-state body (alphabet + freqs +
        # states), not a flagged container — htscodecs calls
        # rans_uncompress_O0_4x16 directly here
        u_size = src.uint7()
        c_size = src.uint7()
        table_stream = ByteStream(bytes(
            _rans_nx16_decode_o0(ByteStream(src.read(c_size)), u_size, 4)))
    else:
        table_stream = src

    alphabet = _read_alphabet(table_stream)
    freq_of = {}
    cum_of = {}
    sym_of = {}
    for ctx in alphabet:
        # row of frequencies over the alphabet, zero-run compressed: a zero
        # frequency is followed by a byte counting further zeros
        freqs = [0] * 256
        zero_run = 0
        for s in alphabet:
            if zero_run > 0:
                zero_run -= 1
                continue
            f = table_stream.uint7()
            freqs[s] = f
            if f == 0:
                zero_run = table_stream.byte()
        _normalise_freqs(freqs, 1 << shift)
        lookup = bytearray(1 << shift)
        cums = [0] * 256
        cum = 0
        for s in range(256):
            if freqs[s]:
                cums[s] = cum
                for k in range(cum, cum + freqs[s]):
                    lookup[k] = s
                cum += freqs[s]
        freq_of[ctx] = freqs
        cum_of[ctx] = cums
        sym_of[ctx] = lookup

    states = [src.uint32le() for _ in range(n_states)]
    seg = out_len // n_states
    starts = [j * seg for j in range(n_states)]
    ends = [(j + 1) * seg for j in range(n_states)]
    ends[-1] = out_len
    out = bytearray(out_len)
    mask = (1 << shift) - 1
    last = [0] * n_states
    offsets = list(starts)
    # lockstep over the common segment length, then the last state's tail
    for _ in range(seg):
        for j in range(n_states):
            x = states[j]
            m = x & mask
            ctx = last[j]
            s = sym_of[ctx][m]
            out[offsets[j]] = s
            offsets[j] += 1
            x = freq_of[ctx][s] * (x >> shift) + m - cum_of[ctx][s]
            while x < _RANS_NX16_LOWER:
                x = (x << 16) | src.uint16le()
            states[j] = x
            last[j] = s
    j = n_states - 1
    while offsets[j] < ends[j]:
        x = states[j]
        m = x & mask
        ctx = last[j]
        s = sym_of[ctx][m]
        out[offsets[j]] = s
        offsets[j] += 1
        x = freq_of[ctx][s] * (x >> shift) + m - cum_of[ctx][s]
        while x < _RANS_NX16_LOWER:
            x = (x << 16) | src.uint16le()
        states[j] = x
        last[j] = s
    return out


def _decode_pack_meta(src: ByteStream) -> Tuple[List[int], int, int]:
    """PACK transform metadata: symbol map + packed length (spec:
    DecodePackMeta). Returns (map, n_sym, packed_len)."""
    n_sym = src.byte()
    pack_map = [src.byte() for _ in range(n_sym)]
    packed_len = src.uint7()
    return pack_map, n_sym, packed_len


def _unpack(data: bytes, pack_map: List[int], n_sym: int, out_len: int) -> bytearray:
    """Expand bit-packed symbols (spec: DecodePack): <=1 sym: 0 bits,
    <=2: 1 bit, <=4: 2 bits, <=16: 4 bits."""
    out = bytearray(out_len)
    if n_sym <= 1:
        sym = pack_map[0] if pack_map else 0
        for i in range(out_len):
            out[i] = sym
    elif n_sym <= 2:
        for i in range(out_len):
            out[i] = pack_map[(data[i >> 3] >> (i & 7)) & 1]
    elif n_sym <= 4:
        for i in range(out_len):
            out[i] = pack_map[(data[i >> 2] >> ((i & 3) << 1)) & 3]
    elif n_sym <= 16:
        for i in range(out_len):
            out[i] = pack_map[(data[i >> 1] >> ((i & 1) << 2)) & 15]
    else:
        raise ValueError("CRAM 3.1 PACK: more than 16 symbols")
    return out


def _decode_rle_meta(src: ByteStream) -> Tuple[bytearray, ByteStream, int]:
    """RLE transform metadata (spec: DecodeRLEMeta). Returns
    (rle_symbol_flags[256], run-length stream, literal_len)."""
    rle_meta_len = src.uint7()
    lit_len = src.uint7()
    if rle_meta_len & 1:
        meta = ByteStream(src.read(rle_meta_len >> 1))
    else:
        # compressed metadata: a RAW order-0 4-state body, like the
        # compressed order-1 frequency table (htscodecs
        # rans_uncompress_O0_4x16, no container flags)
        comp_len = src.uint7()
        meta = ByteStream(bytes(_rans_nx16_decode_o0(
            ByteStream(src.read(comp_len)), rle_meta_len >> 1, 4)))
    flags = bytearray(256)
    n = meta.byte()
    if n == 0:
        n = 256
    for _ in range(n):
        flags[meta.byte()] = 1
    return flags, meta, lit_len


def _expand_rle(literals, rle_flags: bytearray, runs: ByteStream,
                out_len: int) -> bytearray:
    """Expand run-length-encoded literals (spec: DecodeRLE)."""
    out = bytearray(out_len)
    j = 0
    for b in literals:
        out[j] = b
        j += 1
        if rle_flags[b]:
            run = runs.uint7()
            for _ in range(run):
                out[j] = b
                j += 1
    if j != out_len:
        raise ValueError("CRAM 3.1 RLE: expanded size mismatch")
    return out


def rans4x16_decode(data, out_len: Optional[int] = None) -> bytes:
    """Decode one rANS Nx16 container (CRAM 3.1 block method 5)."""
    native = engine()
    if native is not None:
        return native.codec_rans4x16(bytes(data),
                                     -1 if out_len is None else out_len)
    return _rans4x16_decode_py(data, out_len)


def _rans4x16_decode_py(data, out_len: Optional[int] = None) -> bytes:
    src = ByteStream(data)
    flags = src.byte()
    if not (flags & F_NOSZ):
        embedded = src.uint7()
        if out_len is not None and embedded != out_len:
            raise ValueError("rans4x16: size field mismatch")
        out_len = embedded
    if out_len is None:
        raise ValueError("rans4x16: NOSZ stream without an external size")

    if flags & F_STRIPE:
        # N interleaved substreams, each a full container (spec:
        # DecodeStripe); substream j holds bytes i with i % N == j
        n = src.byte()
        clens = [src.uint7() for _ in range(n)]
        ulens = [(out_len - j + n - 1) // n for j in range(n)]
        subs = [rans4x16_decode(src.read(clens[j]), ulens[j])
                for j in range(n)]
        out = bytearray(out_len)
        for j in range(n):
            out[j::n] = subs[j]
        return bytes(out)

    cur_len = out_len
    pack_map = None
    if flags & F_PACK:
        pack_map, pack_nsym, cur_len = _decode_pack_meta(src)
        if cur_len > out_len:
            raise ValueError("rans4x16: packed length exceeds output size")
    rle_flags = None
    if flags & F_RLE:
        rle_target = cur_len
        rle_flags, rle_runs, cur_len = _decode_rle_meta(src)
        if cur_len > rle_target:
            raise ValueError("rans4x16: literal length exceeds output size")

    if cur_len == 0:
        payload = bytearray()
    elif flags & F_CAT:
        payload = bytearray(src.read(cur_len))
    else:
        n_states = 32 if flags & F_X32 else 4
        if flags & F_ORDER1:
            payload = _rans_nx16_decode_o1(src, cur_len, n_states)
        else:
            payload = _rans_nx16_decode_o0(src, cur_len, n_states)

    if rle_flags is not None:
        payload = _expand_rle(payload, rle_flags, rle_runs, rle_target)
    if pack_map is not None:
        payload = _unpack(payload, pack_map, pack_nsym, out_len)
    if len(payload) != out_len:
        raise ValueError("rans4x16: output size mismatch")
    return bytes(payload)


# ---------------------------------------------------------------------------
# adaptive arithmetic coder (method 6)

_RC_TOP = 1 << 24
_MODEL_STEP = 16
_MODEL_MAX_TOTAL = (1 << 16) - 17


class RangeDecoder:
    """Carry-less range decoder (spec: Arithmetic coding; the classic
    Subbotin/LZMA-style coder used by fqzcomp): 32-bit range, code primed
    with 5 bytes, byte-wise renormalization at 2^24."""

    __slots__ = ("src", "range", "code")

    def __init__(self, src: ByteStream):
        self.src = src
        self.range = 0xFFFFFFFF
        code = 0
        for _ in range(5):
            code = ((code << 8) | src.byte()) & 0xFFFFFFFFFF
        self.code = code

    def get_freq(self, total: int) -> int:
        self.range //= total
        return self.code // self.range

    def decode(self, cum: int, freq: int) -> None:
        self.code -= cum * self.range
        self.range *= freq
        while self.range < _RC_TOP:
            self.range <<= 8
            self.code = ((self.code << 8) |
                         (self.src.byte() if not self.src.exhausted() else 0))


class AdaptiveModel:
    """Byte-wise adaptive frequency model (spec: simple adaptive model):
    all symbols start at frequency 1; +16 per hit; kept approximately
    frequency-sorted by neighbour swaps; halved (ceil) when the total
    exceeds 2^16-17. The swap and halving schedules are part of the
    bitstream format."""

    __slots__ = ("total", "syms", "freqs")

    def __init__(self, n_sym: int):
        self.total = n_sym
        self.syms = list(range(n_sym))
        self.freqs = [1] * n_sym

    def decode(self, rc: RangeDecoder) -> int:
        f = rc.get_freq(self.total)
        cum = 0
        i = 0
        freqs = self.freqs
        while cum + freqs[i] <= f:
            cum += freqs[i]
            i += 1
        sym = self.syms[i]
        rc.decode(cum, freqs[i])
        freqs[i] += _MODEL_STEP
        self.total += _MODEL_STEP
        if i > 0 and freqs[i] > freqs[i - 1]:
            freqs[i], freqs[i - 1] = freqs[i - 1], freqs[i]
            self.syms[i], self.syms[i - 1] = self.syms[i - 1], self.syms[i]
        if self.total > _MODEL_MAX_TOTAL:
            total = 0
            for k in range(len(freqs)):
                freqs[k] -= freqs[k] >> 1
                total += freqs[k]
            self.total = total
        return sym


def arith_decode(data, out_len: Optional[int] = None) -> bytes:
    """Decode one adaptive-arithmetic container (CRAM 3.1 method 6)."""
    src = ByteStream(data)
    flags = src.byte()
    if not (flags & F_NOSZ):
        embedded = src.uint7()
        if out_len is not None and embedded != out_len:
            raise ValueError("arith: size field mismatch")
        out_len = embedded
    if out_len is None:
        raise ValueError("arith: NOSZ stream without an external size")

    if flags & F_STRIPE:
        n = src.byte()
        clens = [src.uint7() for _ in range(n)]
        ulens = [(out_len - j + n - 1) // n for j in range(n)]
        subs = [arith_decode(src.read(clens[j]), ulens[j]) for j in range(n)]
        out = bytearray(out_len)
        for j in range(n):
            out[j::n] = subs[j]
        return bytes(out)

    cur_len = out_len
    pack_map = None
    if flags & F_PACK:
        pack_map, pack_nsym, cur_len = _decode_pack_meta(src)

    if cur_len == 0:
        payload = bytearray()
    elif flags & F_EXT:
        payload = bytearray(bz2.decompress(
            bytes(src.data[src.pos:])))[:cur_len]
    elif flags & F_CAT:
        payload = bytearray(src.read(cur_len))
    elif flags & F_RLE:
        # modelled RLE: literal symbols from one adaptive model, run
        # lengths as 255-extended parts — the first part keyed by the
        # literal symbol, continuations by two shared contexts. NOTE: the
        # continuation-context scheme is the least-pinned corner of the
        # spec here; the exact-inverse tests guarantee self-consistency,
        # and the plain order-0/1 paths (which real encoders emit for
        # nearly all series) are framing-exact.
        rc = RangeDecoder(src)
        lit_model = AdaptiveModel(256)
        run_models = [AdaptiveModel(256) for _ in range(258)]
        payload = bytearray(cur_len)
        i = 0
        if flags & F_ORDER1:
            ctx_models = [AdaptiveModel(256) for _ in range(256)]
            last = 0
            while i < cur_len:
                sym = ctx_models[last].decode(rc)
                payload[i] = sym
                i += 1
                last = sym
                run, part = 0, 255
                rm = sym & 0xFF
                while part == 255:
                    part = run_models[rm].decode(rc)
                    run += part
                    rm = 256 if rm == sym else 257
                if run > cur_len - i:
                    raise ValueError("arith RLE: run exceeds block size")
                for _ in range(run):
                    payload[i] = sym
                    i += 1
        else:
            while i < cur_len:
                sym = lit_model.decode(rc)
                payload[i] = sym
                i += 1
                run, part = 0, 255
                rm = sym & 0xFF
                while part == 255:
                    part = run_models[rm].decode(rc)
                    run += part
                    rm = 256 if rm == sym else 257
                if run > cur_len - i:
                    raise ValueError("arith RLE: run exceeds block size")
                for _ in range(run):
                    payload[i] = sym
                    i += 1
    else:
        rc = RangeDecoder(src)
        payload = bytearray(cur_len)
        if flags & F_ORDER1:
            models = [AdaptiveModel(256) for _ in range(256)]
            last = 0
            for i in range(cur_len):
                sym = models[last].decode(rc)
                payload[i] = sym
                last = sym
        else:
            model = AdaptiveModel(256)
            for i in range(cur_len):
                payload[i] = model.decode(rc)

    if pack_map is not None:
        payload = _unpack(payload, pack_map, pack_nsym, out_len)
    if len(payload) != out_len:
        raise ValueError("arith: output size mismatch")
    return bytes(payload)


# ---------------------------------------------------------------------------
# name tokeniser (method 8)

# token types (spec: Name tokenisation codec)
T_TYPE, T_STRING, T_CHAR, T_DIGITS0, T_DZLEN, T_DUP, T_DIFF = range(7)
T_DIGITS, T_DELTA, T_DELTA0, T_MATCH, T_NOP, T_END = range(7, 13)
_N_TTYPES = 13


class _TokenStream:
    __slots__ = ("stream",)

    def __init__(self, data: bytes):
        self.stream = ByteStream(data)

    def byte(self) -> int:
        return self.stream.byte()

    def uint32le(self) -> int:
        return self.stream.uint32le()

    def string(self) -> bytes:
        data = self.stream.data
        pos = self.stream.pos
        end = data.index(0, pos)
        self.stream.pos = end + 1
        return bytes(data[pos:end])


def tok3_decode_names(data, out_len: Optional[int] = None,
                      separator: bytes = b"\x00") -> bytes:
    """Decode a name-tokeniser block (CRAM 3.1 method 8) back to
    separator-joined read names (the encoder consumes '\\0'- or '\\n'-
    separated names; CRAM slices use '\\0')."""
    src = ByteStream(data)
    ulen = src.uint32le()
    n_names = src.uint32le()
    use_arith = src.byte()
    if out_len is not None and n_names > max(out_len, ulen) + 1:
        raise ValueError("tok3: name count exceeds block size")
    decode_stream = arith_decode if use_arith else rans4x16_decode

    # token byte streams, keyed [position][token_type]; streams arrive
    # grouped by position, the first stream of each position flagged 0x80
    streams = {}
    pos = -1
    while not src.exhausted():
        ttype = src.byte()
        tok_new = ttype & 0x80
        tok_dup = ttype & 0x40
        token_type = ttype & 0x3F
        if token_type >= _N_TTYPES:
            raise ValueError(f"tok3: bad token type {token_type}")
        if tok_new:
            pos += 1
        if tok_dup:
            dup_pos = src.byte()
            dup_type = src.byte()
            streams.setdefault(pos, {})[token_type] = _TokenStream(
                streams[dup_pos][dup_type].stream.data)
        else:
            clen = src.uint7()
            payload = src.read(clen)
            ulen_tok = None  # container embeds its own size
            streams.setdefault(pos, {})[token_type] = _TokenStream(
                decode_stream(payload, ulen_tok))

    def stream_at(p: int, t: int) -> _TokenStream:
        try:
            return streams[p][t]
        except KeyError:
            raise ValueError(f"tok3: missing stream for pos {p} type {t}")

    names: List[List[bytes]] = []     # per name: token list
    out_parts: List[bytes] = []
    for n in range(n_names):
        t0 = stream_at(0, T_TYPE).byte()
        if t0 == T_DUP:
            dist = stream_at(0, T_DUP).uint32le()
            if dist >= n:
                raise ValueError("tok3: DUP distance out of range")
            ref = names[n - 1 - dist]
            names.append(list(ref))
            out_parts.append(b"".join(ref))
            continue
        if t0 != T_DIFF:
            raise ValueError("tok3: name must start with DIFF or DUP")
        dist = stream_at(0, T_DIFF).uint32le()
        if n and dist >= n:
            raise ValueError("tok3: DIFF distance out of range")
        ref = names[n - 1 - dist] if n else []
        tokens: List[bytes] = []
        p = 0
        while True:
            p += 1
            t = stream_at(p, T_TYPE).byte()
            if t == T_END:
                break
            if t == T_MATCH:
                tokens.append(ref[p - 1])
            elif t == T_STRING:
                tokens.append(stream_at(p, T_STRING).string())
            elif t == T_CHAR:
                tokens.append(bytes([stream_at(p, T_CHAR).byte()]))
            elif t == T_DIGITS:
                value = stream_at(p, T_DIGITS).uint32le()
                tokens.append(b"%d" % value)
            elif t == T_DIGITS0:
                value = stream_at(p, T_DIGITS0).uint32le()
                width = stream_at(p, T_DZLEN).byte()
                tokens.append(b"%0*d" % (width, value))
            elif t == T_DELTA:
                delta = stream_at(p, T_DELTA).byte()
                value = int(ref[p - 1]) + delta
                tokens.append(b"%d" % value)
            elif t == T_DELTA0:
                delta = stream_at(p, T_DELTA0).byte()
                value = int(ref[p - 1]) + delta
                tokens.append(b"%0*d" % (len(ref[p - 1]), value))
            elif t == T_NOP:
                tokens.append(b"")   # placeholder keeps positions aligned
            else:
                raise ValueError(f"tok3: unhandled token type {t}")
        names.append(tokens)
        out_parts.append(b"".join(tokens))

    out = separator.join(out_parts) + separator
    if out_len is not None and len(out) != out_len:
        # some writers exclude the trailing separator from ulen
        if len(out) - len(separator) == out_len:
            out = out[:-len(separator)]
        elif ulen not in (len(out), len(out) - len(separator)):
            raise ValueError("tok3: decoded size mismatch")
    return out


# ---------------------------------------------------------------------------
# fqzcomp (method 7)

# gflags
FQZ_GFLAG_MULTI_PARAM = 0x01
FQZ_GFLAG_HAVE_STAB = 0x02
FQZ_GFLAG_DO_REV = 0x04
# pflags
FQZ_PFLAG_DO_DEDUP = 0x02
FQZ_PFLAG_DO_LEN = 0x04
FQZ_PFLAG_DO_SEL = 0x08
FQZ_PFLAG_HAVE_QMAP = 0x10
FQZ_PFLAG_HAVE_PTAB = 0x20
FQZ_PFLAG_HAVE_DTAB = 0x40
FQZ_PFLAG_HAVE_QTAB = 0x80


def _fqz_read_array(src: ByteStream, n: int) -> List[int]:
    """Context-mapping array stored as run lengths of the ascending values
    0, 1, 2, ... — each run length byte-extended while 255 (spec: fqzcomp
    ReadArray)."""
    out = [0] * n
    j = 0
    value = 0
    while j < n:
        run = 0
        while True:
            x = src.byte()
            run += x
            if x != 255:
                break
        for _ in range(min(run, n - j)):
            out[j] = value
            j += 1
        value += 1
    return out


class _FqzParam:
    __slots__ = ("context", "pflags", "max_sym", "qbits", "qshift", "qloc",
                 "sloc", "ploc", "dloc", "qmap", "qtab", "ptab", "dtab",
                 "do_dedup", "do_len", "do_sel", "have_qmap")

    def __init__(self, src: ByteStream):
        self.context = src.uint16le()
        self.pflags = src.byte()
        self.do_dedup = bool(self.pflags & FQZ_PFLAG_DO_DEDUP)
        self.do_len = bool(self.pflags & FQZ_PFLAG_DO_LEN)
        self.do_sel = bool(self.pflags & FQZ_PFLAG_DO_SEL)
        self.have_qmap = bool(self.pflags & FQZ_PFLAG_HAVE_QMAP)
        self.max_sym = src.byte()
        x = src.byte()
        self.qbits = x >> 4
        self.qshift = x & 15
        x = src.byte()
        self.qloc = x >> 4
        self.sloc = x & 15
        x = src.byte()
        self.ploc = x >> 4
        self.dloc = x & 15
        if self.have_qmap:
            self.qmap = [src.byte() for _ in range(self.max_sym + 1)]
        else:
            self.qmap = None
        if self.pflags & FQZ_PFLAG_HAVE_QTAB:
            self.qtab = _fqz_read_array(src, 256)
        else:
            self.qtab = list(range(256))
        if self.pflags & FQZ_PFLAG_HAVE_PTAB:
            self.ptab = _fqz_read_array(src, 1024)
        else:
            self.ptab = None
        if self.pflags & FQZ_PFLAG_HAVE_DTAB:
            self.dtab = _fqz_read_array(src, 256)
        else:
            self.dtab = None


class _LazyModels(dict):
    """Quality-context models created on first use (2^16 possible contexts,
    a handful touched in practice)."""

    def __init__(self, n_sym: int):
        super().__init__()
        self.n_sym = n_sym

    def __missing__(self, ctx):
        model = AdaptiveModel(self.n_sym)
        self[ctx] = model
        return model


def fqzcomp_decode(data, out_len: Optional[int] = None) -> bytes:
    """Decode an fqzcomp quality block (CRAM 3.1 method 7, format vers 5):
    adaptive range coding of quality symbols under a 16-bit context mixing
    previous qualities, position, delta count and selector, with optional
    per-record length/dedup/reversal streams."""
    src = ByteStream(data)
    vers = src.byte()
    if vers != 5:
        raise NotImplementedError(f"fqzcomp version {vers} not supported")
    gflags = src.byte()
    n_param = src.byte() if gflags & FQZ_GFLAG_MULTI_PARAM else 1
    if gflags & FQZ_GFLAG_HAVE_STAB:
        max_sel = src.byte()
        stab = _fqz_read_array(src, 256)
    else:
        max_sel = n_param - 1
        stab = list(range(n_param)) + [n_param - 1] * (256 - n_param)
    params = [_FqzParam(src) for _ in range(n_param)]

    max_sym = max(p.max_sym for p in params)
    rc = RangeDecoder(src)
    qual_models = _LazyModels(max_sym + 1)
    len_models = [AdaptiveModel(256) for _ in range(4)]
    sel_model = AdaptiveModel(max_sel + 1) if max_sel > 0 else None
    rev_model = AdaptiveModel(2)
    dup_model = AdaptiveModel(2)

    if out_len is None:
        raise ValueError("fqzcomp: the block's raw size is required")
    out = bytearray()
    rec_bounds: List[Tuple[int, int, bool]] = []   # (start, len, reversed)
    last_len = 0
    prev_rec: bytes = b""
    while len(out) < out_len:
        sel = sel_model.decode(rc) if sel_model is not None else 0
        pm = params[stab[sel]]
        if pm.do_len or last_len == 0:
            rec_len = (len_models[0].decode(rc)
                       | (len_models[1].decode(rc) << 8)
                       | (len_models[2].decode(rc) << 16)
                       | (len_models[3].decode(rc) << 24))
            last_len = rec_len
        else:
            rec_len = last_len
        if rec_len > out_len - len(out):
            raise ValueError("fqzcomp: record length exceeds block size")
        is_rev = bool(rev_model.decode(rc)) if gflags & FQZ_GFLAG_DO_REV \
            else False
        if pm.do_dedup and dup_model.decode(rc):
            rec = prev_rec
            rec_bounds.append((len(out), rec_len, is_rev))
            out += rec
            prev_rec = rec
            continue

        qctx = 0
        prevq = 0
        delta = 0
        p = rec_len
        ctx = pm.context
        start = len(out)
        for _ in range(rec_len):
            q = qual_models[ctx].decode(rc)
            out.append(pm.qmap[q] if pm.have_qmap else q)
            # context update (spec: fqz_update_ctx — position is read
            # before its countdown)
            qctx = ((qctx << pm.qshift) + pm.qtab[q]) & 0xFFFFFFFF
            ctx = (qctx & ((1 << pm.qbits) - 1)) << pm.qloc
            if pm.ptab is not None:
                ctx += pm.ptab[min(1023, p)] << pm.ploc
            if pm.dtab is not None:
                ctx += pm.dtab[min(255, delta)] << pm.dloc
            if pm.do_sel:
                ctx += sel << pm.sloc
            ctx &= 0xFFFF
            p -= 1
            delta += 1 if prevq != q else 0
            prevq = q
        prev_rec = bytes(out[start:])
        rec_bounds.append((start, rec_len, is_rev))

    if gflags & FQZ_GFLAG_DO_REV:
        for start, rec_len, is_rev in rec_bounds:
            if is_rev:
                out[start:start + rec_len] = \
                    out[start:start + rec_len][::-1]
    if out_len is not None and len(out) != out_len:
        raise ValueError("fqzcomp: output size mismatch")
    return bytes(out)
