"""Fusion output: pileup consensus, transcript assembly, isoform selection,
site/type classification, and the 30-column TSV writer.

Reference parity: source/output_fusions.cpp (all helpers and
write_fusions_to_file). This is where byte-equality is won or lost: the
consensus tie-breaks, ellipsis rewriting, and sort chains follow the
reference exactly.
"""

from __future__ import annotations

import functools
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import trace
from ..annotation.index import IntervalIndex
from ..annotation.tables import Annotation, ExonTable, GeneTable, TranscriptTable
from ..constants import (CIGAR_DEL, CIGAR_DIFF, CIGAR_EQUAL, CIGAR_HARD_CLIP,
                         CIGAR_INS, CIGAR_MATCH, CIGAR_REF_SKIP,
                         CIGAR_SOFT_CLIP, CONFIDENCE_HIGH, CONFIDENCE_LOW,
                         CONFIDENCE_MEDIUM, DOWNSTREAM, FILTER_DUPLICATES,
                         FILTER_NAMES, FILTER_NONE, FORWARD, MATE1, MATE2,
                         REVERSE, SPLIT_READ, SUPPLEMENTARY,
                         TRANSCRIPT_START_GENE1, TRANSCRIPT_START_GENE2,
                         UPSTREAM, cigar_op, cigar_oplen)
from ..fusion import Fusion, Fusions
from ..ingest.stats import Coverage
from ..io.fasta import Assembly
from ..model import ChimericAlignments, strip_hi_tag_from_read_name
from ..seq import COMPLEMENT_LUT, reverse_complement_str
from .protein import get_fusion_peptide_sequence, is_in_frame
from .tags import Tags, annotate_tags
from .protein import ProteinDomains, annotate_retained_protein_domains

Pileup = Dict[int, Dict[str, int]]


def _complement_char(base: int) -> str:
    return chr(COMPLEMENT_LUT[base])


# ---------------------------------------------------------------------------
# pileup (output_fusions.cpp:25-107)


def pileup_chimeric_alignments(read_names: List[str],
                               chimeric_alignments: ChimericAlignments, mate: int,
                               reverse_complement: bool, direction: bool,
                               breakpoint: int, pileup: Pileup,
                               base_runs: Optional[list] = None) -> None:
    """When `base_runs` is given, the per-base M/=/X/S observations are
    appended to it as (read_sequence, read_offset, reference_offset, length)
    runs instead of incrementing the pileup dict — the device path
    (build_device_pileups) turns them into one batched histogram."""
    introns: Dict[Tuple[int, int], int] = defaultdict(int)

    for name in read_names:
        mates = chimeric_alignments[name]
        if mates.filter == FILTER_DUPLICATES:
            continue
        read = mates[mate]

        if len(mates) == 2:  # discordant mate
            if not ((direction == DOWNSTREAM and read.strand == FORWARD
                     and breakpoint - 200 <= read.end <= breakpoint + 2)
                    or (direction == UPSTREAM and read.strand == REVERSE
                        and breakpoint - 2 <= read.start <= breakpoint + 200)):
                continue

        if len(mates) == 3 and mate in (SPLIT_READ, SUPPLEMENTARY):
            if read.start != breakpoint and read.end != breakpoint:
                continue

        read_sequence = (mates[SPLIT_READ].sequence if mate == SUPPLEMENTARY
                         else read.sequence)
        if reverse_complement:
            read_sequence = reverse_complement_str(read_sequence)

        read_offset = 0
        reference_offset = read.start
        subtract_from_next_element = 0
        cigar = read.cigar
        n_cigar = len(cigar)
        for cigar_element in range(n_cigar):
            word = int(cigar[cigar_element])
            op = cigar_op(word)
            op_length = cigar_oplen(word)
            if op == CIGAR_INS:
                key = read_sequence[read_offset:read_offset + op_length + 1]
                bucket = pileup.setdefault(reference_offset, {})
                bucket[key] = bucket.get(key, 0) + 1
                read_offset += op_length + 1  # take one base from the next element
                reference_offset += 1
                subtract_from_next_element = 1
            elif op == CIGAR_REF_SKIP:
                intron_start = reference_offset
                reference_offset += op_length - subtract_from_next_element
                introns[(intron_start, reference_offset - 1)] += 1
                subtract_from_next_element = 0
            elif op == CIGAR_DEL:
                for _ in range(op_length - subtract_from_next_element):
                    bucket = pileup.setdefault(reference_offset, {})
                    bucket["-"] = bucket.get("-", 0) + 1
                    reference_offset += 1
                subtract_from_next_element = 0
            elif op == CIGAR_HARD_CLIP:
                if mate == SUPPLEMENTARY:
                    read_offset += op_length
            elif op in (CIGAR_SOFT_CLIP, CIGAR_MATCH, CIGAR_EQUAL, CIGAR_DIFF):
                if op == CIGAR_SOFT_CLIP:
                    if (len(mates) == 3 and mate == SPLIT_READ
                            and ((cigar_element == 0 and read.strand == FORWARD)
                                 or (cigar_element == n_cigar - 1 and read.strand == REVERSE))):
                        if cigar_element == 0 and read.strand == FORWARD:
                            reference_offset -= op_length
                        # fall through: the clipped segment joins the pileup
                        # so non-template bases can be found
                    else:
                        read_offset += op_length - subtract_from_next_element
                        continue
                run_length = op_length - subtract_from_next_element
                if base_runs is not None:
                    if run_length > 0:
                        base_runs.append((read_sequence, read_offset,
                                          reference_offset, run_length))
                    read_offset += run_length
                    reference_offset += run_length
                else:
                    for _ in range(run_length):
                        key = read_sequence[read_offset:read_offset + 1]
                        bucket = pileup.setdefault(reference_offset, {})
                        bucket[key] = bucket.get(key, 0) + 1
                        read_offset += 1
                        reference_offset += 1
                subtract_from_next_element = 0

    for (intron_start, intron_end), frequency in introns.items():
        bucket = pileup.setdefault(intron_start, {})
        bucket[">"] = bucket.get(">", 0) + frequency
        bucket = pileup.setdefault(intron_end, {})
        bucket["<"] = bucket.get("<", 0) + frequency
        for i in range(intron_start + 1, intron_end):
            bucket = pileup.setdefault(i, {})
            bucket["_"] = bucket.get("_", 0) + frequency


# ---------------------------------------------------------------------------
# consensus (output_fusions.cpp:109-240)


def get_sequence_from_pileup(pileup: Pileup, breakpoint: int, direction: bool,
                             gene: int, genes: GeneTable, assembly: Assembly
                             ) -> Tuple[str, List[int], str]:
    sorted_positions = sorted(pileup)
    coverages = {pos: sum(pileup[pos].values()) for pos in sorted_positions}
    peak_coverage = max(coverages.values()) if coverages else 0

    low_coverage_fraction = 0.10
    start_idx = 0
    end_idx = len(sorted_positions)
    for i, pos in enumerate(sorted_positions):
        coverage = coverages[pos]
        if direction == DOWNSTREAM:
            if coverage < peak_coverage * low_coverage_fraction:
                start_idx = i
            else:
                break
        else:  # UPSTREAM
            if coverage > peak_coverage * low_coverage_fraction:
                end_idx = i
    if direction == UPSTREAM:
        if end_idx != len(sorted_positions):
            end_idx += 1
    # note: for DOWNSTREAM end_idx stays len; for UPSTREAM if no position had
    # sufficient coverage, end_idx = len (matches the reference's end())

    sequence_parts: List[str] = []
    positions: List[int] = []
    clipped_parts: List[str] = []
    contig_seq = assembly.get(int(genes.contig[gene]))

    intron_open = False
    intron_closed = True
    for i in range(start_idx, end_idx):
        pos = sorted_positions[i]
        if i != start_idx and sorted_positions[i - 1] < pos - 1 and not intron_open:
            sequence_parts.append("...")
            positions.extend([-1, -1, -1])

        # the reference casts the position to unsigned before its bounds
        # check (output_fusions.cpp:155), so NEGATIVE positions (keep-clip
        # pileups near a contig start) read as "N", not a wrapped index
        if contig_seq is not None and 0 <= pos < len(contig_seq):
            reference_base = chr(contig_seq[pos])
        else:
            reference_base = "N"

        bases = pileup[pos]
        most_frequent_base: Optional[str] = None
        most_frequent_count = 0
        coverage = 0
        for base in sorted(bases):
            count = bases[base]
            base_is_intron = base in ("_", ">", "<")
            if (most_frequent_base is None or count > most_frequent_count
                    or (count == most_frequent_count
                        and ((base == reference_base
                              and most_frequent_base not in ("_", ">", "<"))
                             or (base == "<" and most_frequent_base not in ("_", ">"))
                             or base in ("_", ">")))):
                most_frequent_base = base
                most_frequent_count = count
            if not base_is_intron:
                coverage += count

        if ((most_frequent_base in ("_", ">", "<") and most_frequent_count >= coverage)
                or most_frequent_count >= 0.75 * coverage
                or most_frequent_base == reference_base):
            mfb = most_frequent_base
        else:
            mfb = "?"

        if mfb == "_":
            if not intron_open:
                sequence_parts.append("...___")
                positions.extend([-1] * 6)
                intron_open = True
                intron_closed = False
        elif mfb == ">":
            if not intron_open:
                sequence_parts.append("___")
                positions.extend([-1] * 3)
                intron_open = True
                intron_closed = False
        elif mfb == "<":
            if not intron_open:
                sequence_parts.append("...___")
                positions.extend([-1] * 6)
            intron_open = True
            intron_closed = True
        else:
            if not intron_closed:
                sequence_parts.append("...")
                positions.extend([-1] * 3)
            intron_open = False
            intron_closed = True

            if len(mfb) > 1 or (mfb != reference_base and reference_base != "N"):
                mfb = mfb.lower()
            if len(mfb) > 1:  # insertion
                mfb = "[" + mfb[:-1] + "]" + mfb[-1]
                positions.extend([-1] * (len(mfb) - 1))
                if mfb[-1].upper() == reference_base:
                    mfb = mfb[:-1] + mfb[-1].upper()

            if (direction == UPSTREAM and pos < breakpoint) or \
                    (direction == DOWNSTREAM and pos > breakpoint):
                clipped_parts.append(mfb)
            else:
                sequence_parts.append(mfb)
                positions.append(pos)

    return "".join(sequence_parts), positions, "".join(clipped_parts)


# ---------------------------------------------------------------------------
# fusion transcript assembly (output_fusions.cpp:242-466)


def _native_pileup_args(fusion: Fusion, index) -> tuple:
    """Argument tuple for event.cpp ev_transcript_consensus(_batch)."""
    rows = fusion.support_rows
    if rows is not None:
        sr1, sr2, dm = (np.asarray(r, np.int64) for r in rows)
    else:
        sr1 = np.array([index[n] for n in fusion.split_read1_list], np.int64)
        sr2 = np.array([index[n] for n in fusion.split_read2_list], np.int64)
        dm = np.array([index[n] for n in fusion.discordant_mate_list],
                      np.int64)
    return (
        sr1.tobytes(), sr2.tobytes(), dm.tobytes(),
        1 if fusion.direction1 else 0, 1 if fusion.direction2 else 0,
        int(fusion.breakpoint1), int(fusion.breakpoint2))


def _finish_native_consensus(fusion: Fusion, result: tuple
                             ) -> Tuple[str, List[int]]:
    (sequence1, positions1_b, clipped1, sequence2, positions2_b, clipped2,
     non_template_bases) = result
    return _finish_transcript_sequence(
        fusion, sequence1, np.frombuffer(positions1_b, np.int64).tolist(),
        clipped1, sequence2, np.frombuffer(positions2_b, np.int64).tolist(),
        clipped2, non_template_bases)


def _run_pileup_passes(fusion: Fusion, ca: ChimericAlignments,
                       runs1: Optional[list] = None,
                       runs2: Optional[list] = None
                       ) -> Tuple[Pileup, Pileup]:
    """The reference's ten pileup passes over both fusion sides
    (output_fusions.cpp:246-260). With runs1/runs2, the per-base M/=/X/S
    observations are collected instead of accumulated (device path)."""
    pileup1: Pileup = {}
    pileup2: Pileup = {}
    pileup_chimeric_alignments(fusion.split_read1_list, ca, SPLIT_READ, False,
                               fusion.direction1, fusion.breakpoint1, pileup1,
                               runs1)
    pileup_chimeric_alignments(fusion.split_read1_list, ca, MATE1, False,
                               fusion.direction1, fusion.breakpoint1, pileup1,
                               runs1)
    pileup_chimeric_alignments(fusion.split_read1_list, ca, SUPPLEMENTARY,
                               fusion.direction1 == fusion.direction2,
                               fusion.direction2, fusion.breakpoint2, pileup2,
                               runs2)
    pileup_chimeric_alignments(fusion.split_read2_list, ca, SPLIT_READ, False,
                               fusion.direction2, fusion.breakpoint2, pileup2,
                               runs2)
    pileup_chimeric_alignments(fusion.split_read2_list, ca, MATE1, False,
                               fusion.direction2, fusion.breakpoint2, pileup2,
                               runs2)
    pileup_chimeric_alignments(fusion.split_read2_list, ca, SUPPLEMENTARY,
                               fusion.direction1 == fusion.direction2,
                               fusion.direction1, fusion.breakpoint1, pileup1,
                               runs1)
    pileup_chimeric_alignments(fusion.discordant_mate_list, ca, MATE1, False,
                               fusion.direction1, fusion.breakpoint1, pileup1,
                               runs1)
    pileup_chimeric_alignments(fusion.discordant_mate_list, ca, MATE2, False,
                               fusion.direction1, fusion.breakpoint1, pileup1,
                               runs1)
    pileup_chimeric_alignments(fusion.discordant_mate_list, ca, MATE1, False,
                               fusion.direction2, fusion.breakpoint2, pileup2,
                               runs2)
    pileup_chimeric_alignments(fusion.discordant_mate_list, ca, MATE2, False,
                               fusion.direction2, fusion.breakpoint2, pileup2,
                               runs2)
    return pileup1, pileup2


# device-path symbol coding for build_device_pileups: the four plain bases
# ride the device histogram; any other observation (N, lowercase, ...) is
# folded into the pileup dict on the host, so counts stay exact
_DEVICE_BASE_CODE = {"T": 0, "G": 1, "C": 2, "A": 3}
_DEVICE_CODE_BASE = "TGCA"
_DEVICE_WINDOW_CAP = 4096
_DEVICE_ROW_CHUNK = 256


def build_device_pileups(eligible: List[Fusion], ca: ChimericAlignments
                         ) -> Dict[int, Tuple[Pileup, Pileup]]:
    """Batch the per-base pileup accumulation of every eligible fusion
    through the device histogram (ops/pileup.pileup_histogram): the host
    walks CIGARs collecting (sequence, offset, position, length) runs, the
    device scatter-adds all base observations at once, and the integer
    counts merge back into the exact host Pileup dicts (the consensus
    walk in get_sequence_from_pileup iterates keys in sorted order, so
    dict insertion order cannot affect output)."""
    import numpy as np

    from ..device import torch_device
    from ..ops.pileup import pileup_histogram

    device = torch_device()

    rows = []      # (pileup dict, [runs])
    cache: Dict[int, Tuple[Pileup, Pileup]] = {}
    for f in eligible:
        runs1: list = []
        runs2: list = []
        pileup1, pileup2 = _run_pileup_passes(f, ca, runs1, runs2)
        cache[id(f)] = (pileup1, pileup2)
        rows.append((pileup1, runs1))
        rows.append((pileup2, runs2))

    def host_replay(pileup: Pileup, runs: list) -> None:
        for seq, off, ref, length in runs:
            for k in range(length):
                bucket = pileup.setdefault(ref + k, {})
                key = seq[off + k]
                bucket[key] = bucket.get(key, 0) + 1

    pending = []   # (row_slot, pileup, lo) for device rows, chunked
    codes_parts, cols_parts, row_parts = [], [], []
    window = 256
    for pileup, runs in rows:
        if not runs:
            continue
        lo = min(ref for _, _, ref, _ in runs)
        hi = max(ref + length for _, _, ref, length in runs)
        if hi - lo > _DEVICE_WINDOW_CAP:
            host_replay(pileup, runs)   # pathological span: exact host path
            continue
        slot = len(pending)
        pending.append((pileup, lo))
        window = max(window, hi - lo)
        for seq, off, ref, length in runs:
            raw = np.frombuffer(seq[off:off + length].encode("latin-1"),
                                np.uint8)
            codes = np.full(length, 255, np.int32)
            for ch, code in _DEVICE_BASE_CODE.items():
                codes[raw == ord(ch)] = code
            other = codes == 255
            if other.any():
                for k in np.nonzero(other)[0]:
                    bucket = pileup.setdefault(ref + int(k), {})
                    key = seq[off + int(k)]
                    bucket[key] = bucket.get(key, 0) + 1
                codes = codes[~other]
                cols = (np.arange(length, dtype=np.int32)
                        + (ref - lo))[~other]
            else:
                cols = np.arange(length, dtype=np.int32) + (ref - lo)
            codes_parts.append(codes)
            cols_parts.append(cols)
            row_parts.append(np.full(len(codes), slot, np.int32))

    if pending:
        window = -(-window // 256) * 256
        all_codes = np.concatenate(codes_parts).astype(np.int32)
        all_cols = np.concatenate(cols_parts).astype(np.int32)
        all_rows = np.concatenate(row_parts).astype(np.int32)
        for base in range(0, len(pending), _DEVICE_ROW_CHUNK):
            chunk = pending[base:base + _DEVICE_ROW_CHUNK]
            mask = (all_rows >= base) & (all_rows < base + len(chunk))
            codes = all_codes[mask]
            cols = all_cols[mask]
            rows = all_rows[mask] - base
            # pad the observation count to a power-of-two bucket and the
            # row count to the fixed chunk size, so the device sees few
            # distinct shapes (padded observations carry column -1, dropped
            # by the valid mask)
            bucket = 1 << max(8, int(np.ceil(np.log2(max(len(codes), 1)))))
            pad = bucket - len(codes)
            if pad:
                codes = np.concatenate([codes, np.zeros(pad, np.int32)])
                cols = np.concatenate([cols, np.full(pad, -1, np.int32)])
                rows = np.concatenate([rows, np.zeros(pad, np.int32)])
            histogram = pileup_histogram(
                *(trace.upload(x, device) for x in (codes, cols, rows)),
                _DEVICE_ROW_CHUNK, window).cpu().numpy()
            for local, (pileup, lo) in enumerate(chunk):
                nz_col, nz_sym = np.nonzero(histogram[local, :, :4])
                counts = histogram[local, nz_col, nz_sym]
                for col, sym, count in zip(nz_col, nz_sym, counts):
                    bucket = pileup.setdefault(lo + int(col), {})
                    key = _DEVICE_CODE_BASE[int(sym)]
                    bucket[key] = bucket.get(key, 0) + int(count)
    return cache


def get_fusion_transcript_sequence(fusion: Fusion,
                                   chimeric_alignments: ChimericAlignments,
                                   genes: GeneTable, assembly: Assembly,
                                   precomputed: Optional[tuple] = None,
                                   prebuilt_pileups: Optional[
                                       Tuple[Pileup, Pileup]] = None
                                   ) -> Tuple[str, List[int]]:
    if fusion.predicted_strands_ambiguous or fusion.transcript_start_ambiguous:
        return ".", [-1]
    if precomputed is not None:
        # consensus already computed by ev_transcript_consensus_batch
        return _finish_native_consensus(fusion, precomputed)

    native = getattr(chimeric_alignments, "native", None)
    if (native is not None
            and not getattr(chimeric_alignments, "_materialized", True)):
        # the fragments still live in the native store: run all ten pileup
        # passes, the non-template-base scan and the per-pileup consensus
        # there (event.cpp consensus_from_pileup); only the string assembly
        # tail runs here
        return _finish_native_consensus(
            fusion, native.ev_transcript_consensus(
                *_native_pileup_args(fusion, chimeric_alignments._index),
                int(fusion.gene1), int(fusion.gene2)))

    if prebuilt_pileups is not None:
        pileup1, pileup2 = prebuilt_pileups   # from build_device_pileups
    else:
        pileup1, pileup2 = _run_pileup_passes(fusion, chimeric_alignments)
    ca = chimeric_alignments

    # non-template bases inserted between the fused genes
    non_template_bases = 0
    non_template_bases_count: Dict[int, int] = defaultdict(int)
    for name in fusion.split_read1_list + fusion.split_read2_list:
        mates = ca[name]
        split = mates[SPLIT_READ]
        supp = mates[SUPPLEMENTARY]
        clipped_split_read = (split.preclipping() if split.strand == FORWARD
                              else split.postclipping())
        clipped_supplementary = (supp.postclipping() if supp.strand == FORWARD
                                 else supp.preclipping())
        if clipped_split_read + clipped_supplementary >= len(split.sequence):
            unmapped_bases = clipped_split_read + clipped_supplementary - len(split.sequence)
            non_template_bases_count[unmapped_bases] += 1
            if non_template_bases_count[unmapped_bases] > non_template_bases_count[non_template_bases]:
                non_template_bases = unmapped_bases

    return _assemble_transcript_sequence(fusion, pileup1, pileup2,
                                         non_template_bases, genes, assembly)


def _assemble_transcript_sequence(fusion, pileup1, pileup2,
                                  non_template_bases, genes, assembly):
    """output_fusions.cpp:242-466 tail: consensus, ellipses, breakpoint
    markers, strand orientation (shared by the native and Python pileup
    paths)."""
    sequence1, positions1, clipped_sequence1 = get_sequence_from_pileup(
        pileup1, fusion.breakpoint1, fusion.direction1, fusion.gene1, genes, assembly)
    sequence2, positions2, clipped_sequence2 = get_sequence_from_pileup(
        pileup2, fusion.breakpoint2, fusion.direction2, fusion.gene2, genes, assembly)
    return _finish_transcript_sequence(fusion, sequence1, positions1,
                                       clipped_sequence1, sequence2,
                                       positions2, clipped_sequence2,
                                       non_template_bases)


def _finish_transcript_sequence(fusion, sequence1, positions1,
                                clipped_sequence1, sequence2, positions2,
                                clipped_sequence2, non_template_bases):
    """output_fusions.cpp:300-466: ellipses, non-template bases, breakpoint
    markers, strand orientation and simplification over the two consensus
    halves (native ev_transcript_consensus or get_sequence_from_pileup)."""
    # without split reads, exact breakpoints are unknown => ellipsis
    if len(fusion.split_read1_list) + len(fusion.split_read2_list) == 0:
        if fusion.direction1 == DOWNSTREAM:
            sequence1 += "..."
            positions1.extend([-1] * 3)
        else:
            sequence1 = "..." + sequence1
            positions1[0:0] = [-1] * 3
        if fusion.direction2 == DOWNSTREAM:
            sequence2 += "..."
            positions2.extend([-1] * 3)
        else:
            sequence2 = "..." + sequence2
            positions2[0:0] = [-1] * 3

    # add non-template bases (if any)
    if non_template_bases > 0:
        if len(clipped_sequence1) >= non_template_bases:
            clipped_sequence1 = clipped_sequence1.lower()
            if fusion.direction1 == UPSTREAM:
                sequence1 = clipped_sequence1[len(clipped_sequence1) - non_template_bases:] + sequence1
                positions1[0:0] = [-1] * non_template_bases
            else:
                sequence1 += clipped_sequence1[:non_template_bases]
                positions1.extend([-1] * non_template_bases)
        elif len(clipped_sequence2) >= non_template_bases:
            clipped_sequence2 = clipped_sequence2.lower()
            if fusion.direction2 == UPSTREAM:
                sequence2 = clipped_sequence2[len(clipped_sequence2) - non_template_bases:] + sequence2
                positions2[0:0] = [-1] * non_template_bases
            else:
                sequence2 += clipped_sequence2[:non_template_bases]
                positions2.extend([-1] * non_template_bases)

    # mismatched (lowercase) bases next to the breakpoints = non-template bases
    sequence1_has_non_template_bases = False
    sequence2_has_non_template_bases = False
    if fusion.direction1 == UPSTREAM:
        base = 0
        while base < len(sequence1) and sequence1[base] in "atcg":
            base += 1
        if 0 < base < len(sequence1):
            sequence1 = sequence1[:base] + "|" + sequence1[base:]
            for k in range(base):
                positions1[k] = -1
            positions1.insert(base, -1)
            sequence1_has_non_template_bases = True
    else:
        base = len(sequence1) - 1
        while base >= 0 and sequence1[base] in "atcg":
            base -= 1
        if base + 1 < len(sequence1) and base >= 0:
            sequence1 = sequence1[:base + 1] + "|" + sequence1[base + 1:]
            for k in range(base + 1, len(positions1)):
                positions1[k] = -1
            positions1.insert(base + 1, -1)
            sequence1_has_non_template_bases = True
    if fusion.direction2 == UPSTREAM:
        base = 0
        while base < len(sequence2) and sequence2[base] in "atcg":
            base += 1
        if 0 < base < len(sequence2):
            sequence2 = sequence2[:base] + "|" + sequence2[base:]
            for k in range(base):
                positions2[k] = -1
            positions2.insert(base, -1)
            sequence2_has_non_template_bases = True
    else:
        base = len(sequence2) - 1
        while base >= 0 and sequence2[base] in "atcg":
            base -= 1
        if base + 1 < len(sequence2) and base >= 0:
            sequence2 = sequence2[:base + 1] + "|" + sequence2[base + 1:]
            for k in range(base + 1, len(positions2)):
                positions2[k] = -1
            positions2.insert(base + 1, -1)
            sequence2_has_non_template_bases = True

    if fusion.transcript_start == TRANSCRIPT_START_GENE1:
        if fusion.predicted_strand1 == FORWARD:
            sequence = sequence1
        else:
            sequence = reverse_complement_str(sequence1)
            positions1.reverse()
        positions = list(positions1)
        if not sequence1_has_non_template_bases or not sequence2_has_non_template_bases:
            sequence += "|"
            positions.append(-1)
        if fusion.direction2 == UPSTREAM:
            sequence += sequence2
        else:
            sequence += reverse_complement_str(sequence2)
            positions2.reverse()
        positions.extend(positions2)
    else:
        if fusion.predicted_strand2 == FORWARD:
            sequence = sequence2
        else:
            sequence = reverse_complement_str(sequence2)
            positions2.reverse()
        positions = list(positions2)
        if not sequence2_has_non_template_bases or not sequence1_has_non_template_bases:
            sequence += "|"
            positions.append(-1)
        if fusion.direction1 == UPSTREAM:
            sequence += sequence1
        else:
            sequence += reverse_complement_str(sequence1)
            positions1.reverse()
        positions.extend(positions1)

    # simplify "...A..." etc. to "..."
    max_bases_between_ellipses = 10
    first_ellipsis = 0
    while True:
        first_ellipsis = sequence.find("...", first_ellipsis)
        if first_ellipsis < 0:
            break
        second_ellipsis = sequence.find("...", first_ellipsis + 3)
        pipe = sequence.find("|", first_ellipsis + 3)
        if pipe < 0:
            pipe = len(sequence) + 1
        if (0 <= second_ellipsis < first_ellipsis + max_bases_between_ellipses + 3
                and pipe > second_ellipsis):
            sequence = (sequence[:first_ellipsis + 3]
                        + sequence[second_ellipsis + 3:])
            del positions[first_ellipsis + 3:second_ellipsis + 3]
        else:
            first_ellipsis += 3

    # simplify regions with uncertainty
    sequences_to_simplify = [
        ("...___|", "|"), ("|___...", "|"), ("___|", "...|"), ("|___", "|..."),
        ("______", "___"), ("___...___", "___"), ("...___...", "..."),
        ("......", "..."),
    ]
    while True:
        simplified = False
        for search, replace in sequences_to_simplify:
            found = sequence.find(search)
            if found >= 0:
                sequence = sequence[:found] + replace + sequence[found + len(search):]
                if len(search) > len(replace):
                    del positions[found:found + len(search) - len(replace)]
                simplified = True
                break
        if not simplified:
            break

    # remove terminal "..." and "___"
    while sequence[:3] in ("...", "___"):
        sequence = sequence[3:]
        del positions[:3]
    while len(sequence) >= 3 and sequence[-3:] in ("...", "___"):
        sequence = sequence[:-3]
        del positions[-3:]

    if sequence in ("", "|", "...|", "|...", "...|..."):
        return ".", [-1]

    sequence = sequence.replace("n", "?").replace("N", "?")
    return sequence, positions


# ---------------------------------------------------------------------------
# sorting (output_fusions.cpp:468-496)


def _cmp_bool(result: bool) -> int:
    return -1 if result else 1


def sort_fusions_by_support(x: Fusion, y: Fusion) -> int:
    """strict-weak-order comparator; negative if x sorts before y."""
    if x is y:
        return 0
    if x.confidence != y.confidence:
        return _cmp_bool(x.confidence > y.confidence)
    if x.supporting_reads() != y.supporting_reads():
        return _cmp_bool(x.supporting_reads() > y.supporting_reads())
    if x.evalue != y.evalue:
        return _cmp_bool(x.evalue < y.evalue)
    if x.gene1 != y.gene1:
        return _cmp_bool(x.gene1 < y.gene1)
    if x.gene2 != y.gene2:
        return _cmp_bool(x.gene2 < y.gene2)
    if x.breakpoint1 != y.breakpoint1:
        return _cmp_bool(x.breakpoint1 < y.breakpoint1)
    if x.breakpoint2 != y.breakpoint2:
        return _cmp_bool(x.breakpoint2 < y.breakpoint2)
    return 0


# ---------------------------------------------------------------------------
# breakpoint naming & classification (output_fusions.cpp:498-717)


def gene_to_name(gene: int, contig: int, breakpoint: int, genes: GeneTable,
                 gene_index: IntervalIndex) -> str:
    """output_fusions.cpp:498-545."""
    if not genes.is_dummy[gene]:
        return genes.name[gene]

    result_parts: List[str] = []
    if contig < gene_index.n_contigs:
        bounds = gene_index.boundaries[contig]
        idx2 = int(np.searchsorted(bounds, breakpoint, side="left"))
        # upstream: first region before idx2 whose first element is non-dummy
        idx1 = idx2 - 1
        while idx1 >= 0:
            gene_set = gene_index.set_at(contig, idx1)
            if len(gene_set) and not genes.is_dummy[int(gene_set[0])]:
                break
            idx1 -= 1
        if idx1 >= 0:
            for g in gene_index.set_at(contig, idx1):
                g = int(g)
                if not genes.is_dummy[g]:
                    result_parts.append(f"{genes.name[g]}({breakpoint - int(genes.end[g])})")
        # downstream
        while idx2 < len(bounds):
            gene_set = gene_index.set_at(contig, idx2)
            if len(gene_set) and not genes.is_dummy[int(gene_set[0])]:
                break
            idx2 += 1
        if idx2 < len(bounds):
            for g in gene_index.set_at(contig, idx2):
                g = int(g)
                if not genes.is_dummy[g]:
                    result_parts.append(f"{genes.name[g]}({int(genes.start[g]) - breakpoint})")

    return ",".join(result_parts) if result_parts else "."


def get_fusion_type(fusion: Fusion, genes: GeneTable, max_itd_length: int) -> str:
    """output_fusions.cpp:547-614."""
    f = fusion
    g1_dummy, g2_dummy = bool(genes.is_dummy[f.gene1]), bool(genes.is_dummy[f.gene2])
    g1_strand, g2_strand = bool(genes.strand[f.gene1]), bool(genes.strand[f.gene2])
    if f.contig1 != f.contig2:
        if (g1_dummy or g2_dummy
                or (f.direction1 == f.direction2 and g1_strand != g2_strand)
                or (f.direction1 != f.direction2 and g1_strand == g2_strand)):
            return "translocation"
        if ((f.direction1 == UPSTREAM and g1_strand == FORWARD)
            or (f.direction1 == DOWNSTREAM and g1_strand == REVERSE)) and \
           ((f.direction2 == UPSTREAM and g2_strand == FORWARD)
                or (f.direction2 == DOWNSTREAM and g2_strand == REVERSE)):
            return "translocation/3'-3'"
        return "translocation/5'-5'"

    if f.direction1 == DOWNSTREAM and f.direction2 == UPSTREAM:
        if g1_dummy or g2_dummy or g1_strand == g2_strand:
            return "deletion/read-through" if f.is_read_through() else "deletion"
        if g1_strand == FORWARD or g2_strand == REVERSE:
            return "deletion/read-through/5'-5'" if f.is_read_through() else "deletion/5'-5'"
        return "deletion/read-through/3'-3'" if f.is_read_through() else "deletion/3'-3'"
    if f.direction1 == f.direction2:
        if g1_dummy or g2_dummy or g1_strand != g2_strand:
            return "inversion"
        if f.direction1 == UPSTREAM and g1_strand == REVERSE:
            return "inversion/5'-5'"
        return "inversion/3'-3'"
    # direction1 == UPSTREAM && direction2 == DOWNSTREAM
    if g1_dummy or g2_dummy or g1_strand == g2_strand:
        if f.gene1 == f.gene2 and f.spliced1 and f.spliced2:
            return "duplication/non-canonical_splicing"
        if f.is_internal_tandem_duplication(max_itd_length):
            return "duplication/ITD"
        return "duplication"
    if g1_strand == REVERSE:
        return "duplication/5'-5'"
    return "duplication/3'-3'"


def get_fusion_strand(strand: bool, gene: int, predicted_strands_ambiguous: bool,
                      genes: GeneTable) -> str:
    """output_fusions.cpp:616-635."""
    if genes.is_dummy[gene]:
        result = "."
    else:
        result = "+" if bool(genes.strand[gene]) == FORWARD else "-"
    result += "/"
    if predicted_strands_ambiguous:
        result += "."
    else:
        result += "+" if strand == FORWARD else "-"
    return result


def get_fusion_site(gene: int, spliced: bool, exonic: bool, contig: int,
                    breakpoint: int, genes: GeneTable, exons: ExonTable,
                    exon_index: IntervalIndex) -> str:
    """output_fusions.cpp:637-709."""
    if genes.is_dummy[gene] or breakpoint < genes.start[gene] or breakpoint > genes.end[gene]:
        return "intergenic"
    if not exonic:
        return "intron"

    exon_set = exon_index.point_query(contig, breakpoint)
    has_overlapping_exon = False
    is_utr = True
    is_3_end = 0
    is_5_end = 0
    gene_protein_coding = bool(genes.is_protein_coding[gene])
    gene_forward = bool(genes.strand[gene]) == FORWARD
    for e in exon_set:
        e = int(e)
        if exons.gene[e] != gene:
            continue
        has_overlapping_exon = True
        if exons.coding_region_start[e] <= breakpoint <= exons.coding_region_end[e]:
            is_utr = False
        if is_utr and gene_protein_coding:
            if exons.coding_region_start[e] != -1 and exons.coding_region_start[e] > breakpoint:
                if gene_forward:
                    is_5_end += 1
                else:
                    is_3_end += 1
            elif exons.coding_region_end[e] != -1 and exons.coding_region_end[e] < breakpoint:
                if not gene_forward:
                    is_5_end += 1
                else:
                    is_3_end += 1
            else:
                next_exon = int(exons.next_exon[e])
                while next_exon >= 0 and exons.coding_region_start[next_exon] == -1:
                    next_exon = int(exons.next_exon[next_exon])
                previous_exon = int(exons.prev_exon[e])
                while previous_exon >= 0 and exons.coding_region_start[previous_exon] == -1:
                    previous_exon = int(exons.prev_exon[previous_exon])
                if previous_exon >= 0 or next_exon >= 0:
                    if (next_exon < 0) != (not gene_forward):
                        is_3_end += 1
                    else:
                        is_5_end += 1

    if not has_overlapping_exon:
        site = "intron"
    elif gene_protein_coding:
        if is_utr:
            if is_3_end > is_5_end:
                site = "3'UTR"
            elif is_3_end < is_5_end:
                site = "5'UTR"
            elif is_3_end + is_5_end == 0:
                site = "exon"
            else:
                site = "UTR"
        else:
            site = "CDS"
    else:
        site = "exon"
    if spliced and site != "intron":
        site += "/splice-site"
    return site


# ---------------------------------------------------------------------------
# best-transcript selection (output_fusions.cpp:711-818)


def get_transcripts(transcript_sequence: str, transcribed_bases: List[int],
                    gene: int, strand: bool, strand_ambiguous: bool,
                    which_end: int, annotation: Annotation,
                    exon_index: IntervalIndex,
                    native=None) -> List[int]:
    """output_fusions.cpp:719-818."""
    if native is not None:
        result = native.ev_get_transcripts(
            transcript_sequence,
            np.asarray(transcribed_bases, np.int64).tobytes(), int(gene),
            1 if strand else 0, 1 if strand_ambiguous else 0, int(which_end))
        return np.frombuffer(result, np.int64).tolist()
    genes = annotation.genes
    exons = annotation.exons
    transcripts = annotation.transcripts

    if strand_ambiguous or strand != bool(genes.strand[gene]):
        return []

    if which_end == 5:
        from_ = 0
        to = transcript_sequence.find("|")
        if to < 0:
            return []
        while to > 0 and transcribed_bases[to] == -1:
            to -= 1
        if transcribed_bases[to] == -1:
            return []
        breakpoint = to
    else:
        from_ = transcript_sequence.rfind("|")
        if from_ < 0:
            from_ = len(transcript_sequence) + 1
        while from_ < len(transcript_sequence) and transcribed_bases[from_] == -1:
            from_ += 1
        if from_ >= len(transcript_sequence):
            return []
        breakpoint = from_
        to = len(transcript_sequence) - 1
    if transcribed_bases[from_] > transcribed_bases[to]:
        from_, to = to, from_

    contig = int(genes.contig[gene])
    if contig >= exon_index.n_contigs:
        return []
    bounds = exon_index.boundaries[contig]

    score: Dict[int, int] = defaultdict(int)
    peak_score: Dict[int, int] = {}
    is_coding_at_breakpoint: Dict[int, bool] = defaultdict(bool)
    transcribed_utr_bases: Dict[int, int] = defaultdict(int)

    lo = min(from_, to)
    hi = max(from_, to)
    step = 1 if from_ <= to else -1
    position = from_
    idx = int(np.searchsorted(bounds, transcribed_bases[from_], side="left"))
    while idx < len(bounds) and lo <= position <= hi:
        boundary = int(bounds[idx])
        exon_set = [int(e) for e in exon_index.set_at(contig, idx)]
        last_transcribed_base = transcribed_bases[to]
        while lo <= position <= hi and transcribed_bases[position] <= boundary:
            tb = transcribed_bases[position]
            for e in exon_set:
                if exons.gene[e] == gene and exons.start[e] <= tb <= exons.end[e]:
                    t = int(exons.transcript[e])
                    score[t] += 1
                    last_transcribed_base = tb
                    if e == transcripts.first_exon[t] or e == transcripts.last_exon[t]:
                        transcribed_utr_bases[t] += 1
                    if position == breakpoint:
                        if exons.coding_region_start[e] <= tb <= exons.coding_region_end[e]:
                            is_coding_at_breakpoint[t] = True
                        if (abs(tb - exons.start[e]) <= 2 and e != transcripts.first_exon[t]) or \
                           (abs(tb - exons.end[e]) <= 2 and e != transcripts.last_exon[t]):
                            score[t] += 10
            position += step

        for e in exon_set:
            if exons.gene[e] == gene:
                t = int(exons.transcript[e])
                if t not in peak_score or score[t] > peak_score[t]:
                    peak_score[t] = score[t]
                exon_start = int(bounds[idx - 1]) if idx > 0 else int(exons.start[e]) - 1
                exon_length = (min(boundary, transcribed_bases[to])
                               - max(last_transcribed_base + 1, exon_start) + 1)
                if exon_length < 0:
                    exon_length = 2 ** 32 + exon_length  # unsigned wrap => caps at score
                score[t] -= min(exon_length, score[t])
        idx += 1

    if not peak_score:
        return []

    # ensure peak_score reflects defaultdict-insertion semantics: the
    # reference's peak_score[transcript] starts at 0 for never-updated keys
    transcripts_order = list(peak_score.keys())
    best_transcripts: List[int] = [transcripts_order[0]]
    for t in transcripts_order[1:]:
        best0 = best_transcripts[0]
        if peak_score[t] == peak_score[best0] and \
                is_coding_at_breakpoint[best0] == is_coding_at_breakpoint[t]:
            best_transcripts.append(t)
        elif peak_score[t] > peak_score[best0] or (
                not is_coding_at_breakpoint[best0] and is_coding_at_breakpoint[t]
                and (peak_score[t] == peak_score[best0]
                     or (transcribed_utr_bases[t] > 0 and transcribed_utr_bases[best0] > 0
                         and ((peak_score[t] - transcribed_utr_bases[t]) % (2 ** 32))
                         >= ((peak_score[best0] - transcribed_utr_bases[best0]) % (2 ** 32))))):
            best_transcripts = [t]
    if peak_score[best_transcripts[0]] == 0:
        return []

    def transcript_sort_key(t: int):
        first_exon = int(transcripts.first_exon[t])
        last_exon = int(transcripts.last_exon[t])
        length = int(exons.end[last_exon]) - int(exons.start[first_exon])
        return (-int(transcripts.coding_length[t]), -length, t)

    best_transcripts.sort(key=transcript_sort_key)
    if len(best_transcripts) > 1:
        best_transcripts.append(best_transcripts[0])
    return best_transcripts


# ---------------------------------------------------------------------------
# gap filling (output_fusions.cpp:820-1041)


def fill_gaps_in_fusion_transcript_sequence(transcript_sequence: str,
                                            positions: List[int],
                                            transcript_5: Optional[int],
                                            transcript_3: Optional[int],
                                            strand_5: bool, strand_3: bool,
                                            is_itd: bool, annotation: Annotation,
                                            assembly: Assembly
                                            ) -> Tuple[str, List[int]]:
    exons = annotation.exons
    transcripts = annotation.transcripts

    def find_last_of_dots(s: str, pos: int) -> int:
        """C++ find_last_of(\"...\", pos): last '.' at index <= pos."""
        i = min(pos, len(s) - 1)
        while i >= 0:
            if s[i] == ".":
                return i
            i -= 1
        return -1

    # ---- fill gaps in 5' end
    handled_5 = False
    if transcript_5 is not None:
        first_exon_5 = int(transcripts.first_exon[transcript_5])
        last_exon_5 = int(transcripts.last_exon[transcript_5])
        contig_5 = int(exons.contig[first_exon_5])
        contig_seq = assembly.get(contig_5)
        if contig_seq is not None:
            breakpoint = transcript_sequence.find("|")
            gap = find_last_of_dots(transcript_sequence, breakpoint)

            imprecise_breakpoint = False
            skip_to_3 = False
            if gap >= 0 and gap + 1 == breakpoint and gap >= 3:
                imprecise_breakpoint = True
                gap -= 3
            elif gap >= 0 and exons.start[first_exon_5] < positions[gap + 1] < exons.end[last_exon_5]:
                gap += 1
            elif gap < 0 and exons.start[first_exon_5] < positions[0] < exons.end[last_exon_5]:
                gap = 0
            else:
                # trim to transcript boundaries and be done with the 5' end
                for i in range(breakpoint):
                    if exons.start[first_exon_5] <= positions[i] <= exons.end[last_exon_5]:
                        if i > 0:
                            transcript_sequence = transcript_sequence[i:]
                            del positions[:i]
                        break
                if (strand_5 == FORWARD and positions[0] == exons.start[first_exon_5]) or \
                        (strand_5 == REVERSE and positions[0] == exons.end[last_exon_5]):
                    transcript_sequence = "^" + transcript_sequence
                    positions.insert(0, -1)
                skip_to_3 = True

            if not skip_to_3:
                breakpoint = transcript_sequence.find("|")
                overlap_found = False
                overlapping_exon = -1
                while gap != breakpoint:
                    exon = first_exon_5
                    while exon >= 0:
                        if exons.start[exon] <= positions[gap] <= exons.end[exon]:
                            overlap_found = True
                            overlapping_exon = exon
                            break
                        exon = int(exons.next_exon[exon])
                    if overlap_found:
                        break
                    gap += 1

                if imprecise_breakpoint:
                    if (strand_5 == FORWARD and overlapping_exon == last_exon_5) or \
                            (strand_5 == REVERSE and overlapping_exon == first_exon_5) or \
                            is_itd:
                        overlap_found = False

                if overlap_found:
                    if imprecise_breakpoint:
                        gap = breakpoint - 1
                        positions[gap] = (int(exons.end[overlapping_exon]) if strand_5 == FORWARD
                                          else int(exons.start[overlapping_exon]))
                        faked = (chr(contig_seq[positions[gap]]) if strand_5 == FORWARD
                                 else _complement_char(int(contig_seq[positions[gap]])))
                        transcript_sequence = (transcript_sequence[:gap] + faked
                                               + transcript_sequence[gap + 1:])

                    sequence_from_assembly = ["("]
                    positions_from_assembly = [-1]
                    exon = first_exon_5 if strand_5 == FORWARD else last_exon_5
                    while exon >= 0:
                        position = int(exons.start[exon]) if strand_5 == FORWARD else int(exons.end[exon])
                        step = 1 if strand_5 == FORWARD else -1
                        while (position != positions[gap]
                               and exons.start[exon] <= position <= exons.end[exon]):
                            sequence_from_assembly.append(
                                chr(contig_seq[position]) if strand_5 == FORWARD
                                else _complement_char(int(contig_seq[position])))
                            positions_from_assembly.append(position)
                            position += step
                        if position == positions[gap]:
                            break
                        sequence_from_assembly.append("___")
                        positions_from_assembly.extend([-1] * 3)
                        exon = int(exons.next_exon[exon]) if strand_5 == FORWARD \
                            else int(exons.prev_exon[exon])

                    if imprecise_breakpoint:
                        sequence_from_assembly.append(transcript_sequence[gap])
                        positions_from_assembly.append(positions[gap])
                        gap += 1

                    sequence_from_assembly.append(")")
                    positions_from_assembly.append(-1)
                    transcript_sequence = "".join(sequence_from_assembly) + transcript_sequence[gap:]
                    positions[:] = positions_from_assembly + positions[gap:]

                    if (strand_5 == FORWARD and positions[1] == exons.start[first_exon_5]) or \
                            (strand_5 == REVERSE and positions[1] == exons.end[last_exon_5]):
                        transcript_sequence = "^" + transcript_sequence
                        positions.insert(0, -1)

    # ---- fill gaps in 3' end
    if transcript_3 is not None:
        first_exon_3 = int(transcripts.first_exon[transcript_3])
        last_exon_3 = int(transcripts.last_exon[transcript_3])
        contig_3 = int(exons.contig[first_exon_3])
        contig_seq = assembly.get(contig_3)
        if contig_seq is not None:
            breakpoint = transcript_sequence.rfind("|")
            # C++ find(s, npos) == npos when there is no junction character
            gap = transcript_sequence.find("...", breakpoint) if breakpoint >= 0 else -1

            imprecise_breakpoint = False
            done = False
            if gap >= 0 and gap - 1 == breakpoint and gap + 3 < len(transcript_sequence):
                imprecise_breakpoint = True
                gap += 3
            elif gap >= 0 and exons.start[first_exon_3] < positions[gap - 1] < exons.end[last_exon_3]:
                gap -= 1
            elif gap < 0 and exons.start[first_exon_3] < positions[len(transcript_sequence) - 1] \
                    < exons.end[last_exon_3]:
                gap = len(transcript_sequence) - 1
            else:
                for i in range(len(transcript_sequence) - 1, breakpoint, -1):
                    if exons.start[first_exon_3] <= positions[i] <= exons.end[last_exon_3]:
                        if i < len(transcript_sequence) - 1:
                            transcript_sequence = transcript_sequence[:i + 1]
                            del positions[i + 1:]
                        break
                if (strand_3 == FORWARD and positions[-1] == exons.end[last_exon_3]) or \
                        (strand_3 == REVERSE and positions[-1] == exons.start[first_exon_3]):
                    transcript_sequence += "$"
                    positions.append(-1)
                done = True

            if not done:
                overlap_found = False
                overlapping_exon = -1
                while gap != breakpoint:
                    exon = first_exon_3
                    while exon >= 0:
                        if exons.start[exon] <= positions[gap] <= exons.end[exon]:
                            overlap_found = True
                            overlapping_exon = exon
                            break
                        exon = int(exons.next_exon[exon])
                    if overlap_found:
                        break
                    gap -= 1

                if imprecise_breakpoint:
                    if (strand_3 == FORWARD and overlapping_exon == last_exon_3) or \
                            (strand_3 == REVERSE and overlapping_exon == first_exon_3) or \
                            is_itd:
                        overlap_found = False

                if overlap_found:
                    if imprecise_breakpoint:
                        gap = breakpoint + 1
                        positions[gap] = (int(exons.start[overlapping_exon]) if strand_3 == FORWARD
                                          else int(exons.end[overlapping_exon]))
                        faked = (chr(contig_seq[positions[gap]]) if strand_3 == FORWARD
                                 else _complement_char(int(contig_seq[positions[gap]])))
                        transcript_sequence = (transcript_sequence[:gap] + faked
                                               + transcript_sequence[gap + 1:])

                    sequence_from_assembly: List[str] = []
                    positions_from_assembly: List[int] = []
                    exon = overlapping_exon
                    while exon >= 0:
                        if strand_3 == FORWARD:
                            position = max(int(exons.start[exon]), positions[gap] + 1)
                        else:
                            position = min(int(exons.end[exon]), positions[gap] - 1)
                        step = 1 if strand_3 == FORWARD else -1
                        while exons.start[exon] <= position <= exons.end[exon]:
                            sequence_from_assembly.append(
                                chr(contig_seq[position]) if strand_3 == FORWARD
                                else _complement_char(int(contig_seq[position])))
                            positions_from_assembly.append(position)
                            position += step
                        next_e = int(exons.next_exon[exon]) if strand_3 == FORWARD \
                            else int(exons.prev_exon[exon])
                        if next_e >= 0:
                            sequence_from_assembly.append("___")
                            positions_from_assembly.extend([-1] * 3)
                        exon = next_e

                    transcript_sequence = (transcript_sequence[:gap + 1] + "("
                                           + "".join(sequence_from_assembly) + ")")
                    del positions[gap + 1:]
                    positions.append(-1)
                    positions.extend(positions_from_assembly)
                    positions.append(-1)

                    if imprecise_breakpoint:
                        s = list(transcript_sequence)
                        s[breakpoint + 1], s[breakpoint + 2] = s[breakpoint + 2], s[breakpoint + 1]
                        transcript_sequence = "".join(s)
                        positions[breakpoint + 1], positions[breakpoint + 2] = \
                            positions[breakpoint + 2], positions[breakpoint + 1]

                    if (strand_3 == FORWARD and positions[-2] == exons.end[last_exon_3]) or \
                            (strand_3 == REVERSE and positions[-2] == exons.start[first_exon_3]):
                        transcript_sequence += "$"
                        positions.append(-1)

    return transcript_sequence, positions


# ---------------------------------------------------------------------------
# the TSV writer (output_fusions.cpp:1043-1260)

HEADER = ("#gene1\tgene2\tstrand1(gene/fusion)\tstrand2(gene/fusion)\tbreakpoint1\t"
          "breakpoint2\tsite1\tsite2\ttype\tsplit_reads1\tsplit_reads2\t"
          "discordant_mates\tcoverage1\tcoverage2\tconfidence\treading_frame\ttags\t"
          "retained_protein_domains\tclosest_genomic_breakpoint1\t"
          "closest_genomic_breakpoint2\tgene_id1\tgene_id2\ttranscript_id1\t"
          "transcript_id2\tdirection1\tdirection2\tfilters\tfusion_transcript\t"
          "peptide_sequence\tread_identifiers")


def write_fusions_to_file(fusions: Fusions, output_file: str,
                          chimeric_alignments: ChimericAlignments,
                          coverage: Coverage, assembly: Assembly,
                          annotation: Annotation, gene_index: IntervalIndex,
                          exon_index: IntervalIndex,
                          original_contig_names: List[str], tags: Tags,
                          protein_domains: Optional[ProteinDomains],
                          max_mate_gap: int, max_itd_length: int,
                          print_extra_info: bool, fill_sequence_gaps: bool,
                          write_discarded_fusions: bool,
                          threads: int = 1) -> None:
    genes = annotation.genes
    exons = annotation.exons
    transcripts_table = annotation.transcripts

    if write_discarded_fusions:
        # the reference emits discarded rows in its fusions_t hash-map
        # iteration order (output_fusions.cpp:1052); replay it so the
        # discarded file is byte-equal (creation order of the fusions dict
        # equals the reference's first-insert order)
        from .stdmap_order import fusion_map_order
        all_fusions = list(fusions.values())
        order = fusion_map_order(
            [(f.gene1, f.gene2, f.contig1, f.contig2, f.breakpoint1,
              f.breakpoint2, bool(f.direction1), bool(f.direction2))
             for f in all_fusions])
        sorted_fusions = [all_fusions[i] for i in order
                          if all_fusions[i].filter != FILTER_NONE]
    else:
        sorted_fusions = [f for f in fusions.values()
                          if f.filter == FILTER_NONE]

    if not write_discarded_fusions:
        best_by_gene_pair: Dict[Tuple[int, int], Fusion] = {}
        for f in sorted_fusions:
            current = best_by_gene_pair.get((f.gene1, f.gene2))
            if current is None or sort_fusions_by_support(f, current) < 0:
                best_by_gene_pair[(f.gene1, f.gene2)] = f

        def cmp_by_rank_of_best(x: Fusion, y: Fusion) -> int:
            best_x = best_by_gene_pair[(x.gene1, x.gene2)]
            best_y = best_by_gene_pair[(y.gene1, y.gene2)]
            if best_x is not best_y:
                return sort_fusions_by_support(best_x, best_y)
            return sort_fusions_by_support(x, y)

        sorted_fusions.sort(key=functools.cmp_to_key(cmp_by_rank_of_best))

    # native best-transcript selection: bind the transcript tables once and
    # run the scoring walk in C++ (event.cpp ev_get_transcripts)
    native_transcripts = None
    # the native store, while the fragments still live there
    native = getattr(chimeric_alignments, "native", None)
    if getattr(chimeric_alignments, "_materialized", True):
        native = None
    if native is not None:
        try:
            native.ev_bind_transcript_tables(
                np.ascontiguousarray(exons.transcript, np.int64).tobytes(),
                np.ascontiguousarray(transcripts_table.first_exon,
                                     np.int64).tobytes(),
                np.ascontiguousarray(transcripts_table.last_exon,
                                     np.int64).tobytes(),
                np.ascontiguousarray(transcripts_table.coding_length,
                                     np.int64).tobytes())
            native_transcripts = native
        except Exception:  # pragma: no cover - fall back to the Python walk
            native_transcripts = None

    # per-read filter ids without materializing lazy fragments: one native
    # array lookup instead of a Fragment build per supporting read
    native_filters = None
    name_to_index = None
    if native is not None:
        try:
            native_filters = np.frombuffer(native.extract_fragment_filters(),
                                           np.int64)
            name_to_index = chimeric_alignments._index
        except RuntimeError:
            native_filters = None

    def read_filter_of(name: str) -> int:
        if native_filters is not None:
            return int(native_filters[name_to_index[name]])
        return chimeric_alignments[name].filter

    # prefetch every fusion's transcript consensus in ONE native call (the
    # per-fusion pileups are independent, so they run on a thread pool)
    consensus_cache: Dict[int, tuple] = {}
    if print_extra_info and native is not None:
        index = chimeric_alignments._index
        eligible = [f for f in sorted_fusions
                    if not (f.predicted_strands_ambiguous
                            or f.transcript_start_ambiguous)]
        if eligible:
            results = native.ev_transcript_consensus_batch(
                [(*_native_pileup_args(f, index), int(f.gene1), int(f.gene2))
                 for f in eligible], int(threads))
            consensus_cache = {id(f): r for f, r in zip(eligible, results)}

    # device path (the fragments in Python, with an accelerator): batch
    # every fusion's per-base pileup accumulation through ONE device
    # histogram
    pileup_cache: Dict[int, Tuple[Pileup, Pileup]] = {}
    if print_extra_info and native is None:
        from ..device import offload_enabled
        eligible = [f for f in sorted_fusions
                    if not (f.predicted_strands_ambiguous
                            or f.transcript_start_ambiguous)]
        if eligible and offload_enabled():
            pileup_cache = build_device_pileups(eligible, chimeric_alignments)

    lines = [HEADER]
    for f in sorted_fusions:
        site_5 = get_fusion_site(f.gene1, f.spliced1, f.exonic1, f.contig1,
                                 f.breakpoint1, genes, exons, exon_index)
        site_3 = get_fusion_site(f.gene2, f.spliced2, f.exonic2, f.contig2,
                                 f.breakpoint2, genes, exons, exon_index)
        confidence = ("low", "medium", "high")[f.confidence]

        gene_5, gene_3 = f.gene1, f.gene2
        contig_5, contig_3 = f.contig1, f.contig2
        breakpoint_5, breakpoint_3 = f.breakpoint1, f.breakpoint2
        direction_5, direction_3 = f.direction1, f.direction2
        split_reads_5, split_reads_3 = f.split_reads1, f.split_reads2
        strand_5, strand_3 = f.predicted_strand1, f.predicted_strand2
        closest_5, closest_3 = f.closest_genomic_breakpoint1, f.closest_genomic_breakpoint2
        if f.transcript_start == TRANSCRIPT_START_GENE2:
            gene_5, gene_3 = gene_3, gene_5
            direction_5, direction_3 = direction_3, direction_5
            contig_5, contig_3 = contig_3, contig_5
            breakpoint_5, breakpoint_3 = breakpoint_3, breakpoint_5
            site_5, site_3 = site_3, site_5
            split_reads_5, split_reads_3 = split_reads_3, split_reads_5
            strand_5, strand_3 = strand_3, strand_5
            closest_5, closest_3 = closest_3, closest_5

        coverage_5 = coverage.get_coverage(contig_5, breakpoint_5,
                                           DOWNSTREAM if direction_5 == UPSTREAM else UPSTREAM)
        coverage_3 = coverage.get_coverage(contig_3, breakpoint_3,
                                           DOWNSTREAM if direction_3 == UPSTREAM else UPSTREAM)

        transcript_sequence = "."
        transcript_5: Optional[int] = None
        transcript_3: Optional[int] = None
        fusion_peptide_sequence = "."
        reading_frame = "."
        if print_extra_info:
            transcript_sequence, positions = get_fusion_transcript_sequence(
                f, chimeric_alignments, genes, assembly,
                consensus_cache.get(id(f)),
                prebuilt_pileups=pileup_cache.get(id(f)))
            transcript_sequence_backup = transcript_sequence
            positions_backup = list(positions)

            transcripts_5 = get_transcripts(transcript_sequence, positions, gene_5,
                                            strand_5, f.predicted_strands_ambiguous, 5,
                                            annotation, exon_index,
                                            native_transcripts)
            transcripts_3 = get_transcripts(transcript_sequence, positions, gene_3,
                                            strand_3, f.predicted_strands_ambiguous, 3,
                                            annotation, exon_index,
                                            native_transcripts)
            # try all combinations of 5'/3' transcripts until one is in-frame
            list_5 = transcripts_5 if transcripts_5 else [None]
            list_3 = transcripts_3 if transcripts_3 else [None]
            for t_5 in list_5:
                if reading_frame == "in-frame":
                    break
                if t_5 is not None:
                    transcript_5 = t_5
                for t_3 in list_3:
                    if reading_frame == "in-frame":
                        break
                    if t_3 is not None:
                        transcript_3 = t_3
                    if fill_sequence_gaps:
                        transcript_sequence = transcript_sequence_backup
                        positions = list(positions_backup)
                        transcript_sequence, positions = \
                            fill_gaps_in_fusion_transcript_sequence(
                                transcript_sequence, positions, transcript_5,
                                transcript_3, strand_5, strand_3,
                                f.is_internal_tandem_duplication(max_itd_length),
                                annotation, assembly)
                    fusion_peptide_sequence = get_fusion_peptide_sequence(
                        transcript_sequence, positions, gene_5, gene_3, transcript_5,
                        transcript_3, strand_3, annotation, assembly)
                    reading_frame = is_in_frame(fusion_peptide_sequence)
                if not transcripts_3:
                    # the reference breaks after the first 5' candidate when
                    # there are no 3' transcripts (output_fusions.cpp:1160) —
                    # iterating further could report a later 5' transcript
                    break

            if reading_frame == "stop-codon":
                fusion_peptide_sequence = "."

        columns = [
            gene_to_name(gene_5, contig_5, breakpoint_5, genes, gene_index),
            gene_to_name(gene_3, contig_3, breakpoint_3, genes, gene_index),
            get_fusion_strand(strand_5, gene_5, f.predicted_strands_ambiguous, genes),
            get_fusion_strand(strand_3, gene_3, f.predicted_strands_ambiguous, genes),
            f"{original_contig_names[contig_5]}:{breakpoint_5 + 1}",
            f"{original_contig_names[contig_3]}:{breakpoint_3 + 1}",
            site_5, site_3,
            get_fusion_type(f, genes, max_itd_length),
            str(split_reads_5), str(split_reads_3), str(f.discordant_mates),
            str(coverage_5) if coverage_5 >= 0 else ".",
            str(coverage_3) if coverage_3 >= 0 else ".",
            confidence,
            reading_frame,
        ]

        columns.append(annotate_tags(f, tags, genes, max_mate_gap) if tags else ".")

        if protein_domains is not None and len(protein_domains):
            protein_domains_5 = annotate_retained_protein_domains(
                contig_5, breakpoint_5, strand_5, f.predicted_strands_ambiguous,
                gene_5, direction_5, genes, protein_domains)
            protein_domains_3 = annotate_retained_protein_domains(
                contig_3, breakpoint_3, strand_3, f.predicted_strands_ambiguous,
                gene_3, direction_3, genes, protein_domains)
            if protein_domains_5 or protein_domains_3:
                columns.append(f"{protein_domains_5}|{protein_domains_3}")
            else:
                columns.append(".")
        else:
            columns.append(".")

        if closest_5 >= 0:
            columns.append(f"{original_contig_names[contig_5]}:{closest_5 + 1}"
                           f"({abs(breakpoint_5 - closest_5)})")
        else:
            columns.append(".")
        if closest_3 >= 0:
            columns.append(f"{original_contig_names[contig_3]}:{closest_3 + 1}"
                           f"({abs(breakpoint_3 - closest_3)})")
        else:
            columns.append(".")

        # count reads discarded per filter (and pre-build the
        # read_identifiers column natively when the store is live)
        filters: Dict[str, int] = {}
        if f.filter != FILTER_NONE:
            filters[FILTER_NAMES[f.filter]] = 0
        all_supporting_reads = (f.split_read1_list + f.split_read2_list
                                + f.discordant_mate_list)
        joined_read_names = None
        if native_filters is not None:
            if f.support_rows is not None:
                supporting_rows = np.concatenate(
                    [np.asarray(r, np.int64) for r in f.support_rows]) \
                    if any(len(r) for r in f.support_rows) \
                    else np.empty(0, np.int64)
            else:
                supporting_rows = np.array(
                    [name_to_index[n] for n in all_supporting_reads],
                    np.int64)
            joined_read_names, filter_pairs = \
                native.extract_supporting_reads(
                    supporting_rows.tobytes())
            pairs = np.frombuffer(filter_pairs, np.int64)
            for k in range(0, len(pairs), 2):
                filter_name = FILTER_NAMES[int(pairs[k])]
                filters[filter_name] = (filters.get(filter_name, 0)
                                        + int(pairs[k + 1]))
        else:
            for name in all_supporting_reads:
                read_filter = read_filter_of(name)
                if read_filter != FILTER_NONE:
                    filters[FILTER_NAMES[read_filter]] = \
                        filters.get(FILTER_NAMES[read_filter], 0) + 1

        columns.append("." if genes.is_dummy[gene_5] else genes.gene_id[gene_5])
        columns.append("." if genes.is_dummy[gene_3] else genes.gene_id[gene_3])
        columns.append("." if transcript_5 is None else transcripts_table.name[transcript_5])
        columns.append("." if transcript_3 is None else transcripts_table.name[transcript_3])
        columns.append("upstream" if direction_5 == UPSTREAM else "downstream")
        columns.append("upstream" if direction_3 == UPSTREAM else "downstream")

        if not filters:
            columns.append(".")
        else:
            parts = []
            for filter_name in sorted(filters):
                count = filters[filter_name]
                parts.append(filter_name if count == 0 else f"{filter_name}({count})")
            columns.append(",".join(parts))

        columns.append(transcript_sequence)
        columns.append(fusion_peptide_sequence)

        if print_extra_info and all_supporting_reads:
            columns.append(joined_read_names
                           if joined_read_names is not None
                           else ",".join(strip_hi_tag_from_read_name(n)
                                         for n in all_supporting_reads))
        else:
            columns.append(".")

        lines.append("\t".join(columns))

    with open(output_file, "w") as out:
        out.write("\n".join(lines) + "\n")
