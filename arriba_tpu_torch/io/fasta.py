"""Assembly (FASTA) loader.

Reference parity: source/assembly.cpp:28-58 — streams a possibly-gzipped
FASTA, uppercases sequence, keeps only interesting contigs, registers contig
ids shared with the GTF/BAM, and remembers original (chr-prefixed) names.

The assembly is stored as {contig_id: numpy uint8 ASCII array} for O(1)
window slicing; device kernels receive 2-bit re-encoded windows. Parsing is
bulk byte work (record split + one-pass translate that uppercases and
strips newlines) rather than a per-line loop — ~10x faster on a
whole-genome FASTA.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .._native_build import engine
from ..contigs import ContigRegistry, is_interesting_contig

Assembly = Dict[int, np.ndarray]

# one-pass uppercase + newline strip for bytes.translate
_UPPER = bytes.maketrans(bytes(range(ord("a"), ord("z") + 1)),
                         bytes(range(ord("A"), ord("Z") + 1)))


def _read_bytes(path: str):
    """Raw file contents; plain files come back as an mmap (zero-copy for
    the record scan and the native body filler), gzip as bytes."""
    with open(path, "rb") as fh:
        head = fh.read(2)
        fh.seek(0)
        if head == b"\x1f\x8b":
            import gzip
            with gzip.open(fh) as gz:
                return gz.read()
        import mmap
        try:
            return mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):  # empty file / exotic fs
            return fh.read()


def load_assembly(path: str, contigs: ContigRegistry, interesting_contigs: str) -> Assembly:
    data = _read_bytes(path)
    assembly: Dict[int, np.ndarray] = {}

    starts_with_record = data[:1] == b">"  # mmap has no startswith
    pos = 0 if starts_with_record else data.find(b"\n>") + 1
    if pos == 0 and not starts_with_record:
        return assembly  # no FASTA records
    # record discovery + contig registration stay in Python; the byte work
    # (uppercase + newline strip) batches through the threaded native
    # filler when available
    pending: list = []  # (cid, body_start, body_end)
    while pos != -1 and pos < len(data):
        header_end = data.find(b"\n", pos)
        if header_end == -1:
            break
        next_record = data.find(b"\n>", header_end)
        body_end = len(data) if next_record == -1 else next_record + 1
        header = data[pos + 1:header_end].strip()
        fields = header.split()
        if fields:
            name = fields[0].decode("ascii", "replace")
            cid = contigs.add(name)
            if is_interesting_contig(name, interesting_contigs):
                pending.append((cid, header_end + 1, body_end))
        pos = -1 if next_record == -1 else next_record + 1

    native = engine()
    if native is not None and pending:
        import os
        pairs = np.asarray([(s, e) for _c, s, e in pending], np.int64)
        bodies = native.fasta_bodies(data, pairs.tobytes(),
                                     min(os.cpu_count() or 1, 8))
        for (cid, _s, _e), seq in zip(pending, bodies):
            arr = np.frombuffer(seq, dtype=np.uint8)
            if cid in assembly:
                arr = np.concatenate([assembly[cid], arr])
            assembly[cid] = arr
        return assembly

    for cid, body_start, body_end in pending:
        seq = data[body_start:body_end].translate(_UPPER, b"\r\n")
        arr = np.frombuffer(seq, dtype=np.uint8)
        if cid in assembly:
            arr = np.concatenate([assembly[cid], arr])
        assembly[cid] = arr
    return assembly
