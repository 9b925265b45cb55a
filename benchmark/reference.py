"""The plain reference that decides `correct`, in NumPy and plain PyTorch.
It imports nothing of the program.

What it judges, all from the window's own samples:

- the tables (`fusions.tsv`, `fusions.discarded.tsv`): every sample's equal
  the first's, and the first's against what the generator planted. Each
  planted junction is one event of the two tables with its two genes and
  breakpoints; its supporting reads and the
  reads that read-level filters took from it add up to the fragments
  planted there, and the duplicates the row names are those among the
  planted fragments (a split fragment is a duplicate of another with the
  same anchor and mate gap, a discordant pair of another at the same
  start), as are the reads Arriba's mismatch test takes (from the base
  errors the generator planted); it is in `fusions.tsv` exactly where no event-level filter
  discarded it, and one with strong support is there. No other row
  passes, except one that discordant mates alone place at a planted
  junction's genes.
- K2's low-entropy flags on each launch's reads (the first sample's, and
  every later sample's equal to them), worked out from the reads' codes
  and aligned segments with the filter's own threshold arithmetic.
- the mismapper screen, where the cell runs it: K5's verdict on every
  pair of the first sample (does the read, either orientation, share an
  8-mer with its window) and K1's on a draw of its rows (does a
  single-seed alignment reach the pair's minimum score), from the reads
  and windows the screen was handed.
"""

from __future__ import annotations

import math
import re

import numpy as np

KMER_CONTENT = 0.6      # Arriba's default -K (maximum k-mer content)
LE_K = 3                # the low-entropy filter counts 3-mers
SEED_K = 8              # the screen's 8-mers
NEG = -(1 << 20)
FILTER_COUNT = re.compile(r"([A-Za-z_]+)\((\d+)\)")


def _check(value, limit=0) -> dict:
    return {"value": int(value), "limit": limit}


# --------------------------------------------------------------------------
# the tables against the planted junctions

SUBSAMPLING = 300       # Arriba's default -U
# supporting reads from which a planted junction must pass: at 8 reads a
# spliced translocation's e-value is under a tenth of Arriba's cut-off
# (0.3) even where each partner gene has ten other fusion partners
STRONG_SUPPORT = 8
MISMATCH_RATE = 0.01    # Arriba's mismatch filter: the rate it expects
MISMATCH_PVALUE = 0.01  # Arriba's default -V


def mismatch_rejects(mismatches: np.ndarray, aligned: np.ndarray,
                     genome_size: int) -> np.ndarray:
    """Arriba's mismatch test (filter_mismatches.cpp) of alignments with
    no clip that counts and no indel: `mismatches` of `aligned` bases is
    too unlikely under the binomial at MISMATCH_RATE, or, with a mismatch,
    a sequence of that many matches is likely to be found elsewhere in a
    genome of genome_size bases."""
    out = np.zeros(len(mismatches), bool)
    pairs = np.stack([mismatches, aligned], 1) if len(mismatches) else []
    for k, n in {tuple(pair) for pair in np.asarray(pairs).tolist()}:
        ways = math.comb(n, k)
        rejected = ways * MISMATCH_RATE ** k \
            * (1 - MISMATCH_RATE) ** (n - k) < MISMATCH_PVALUE
        if not rejected and k > 0:
            permutations = 4.0 ** (n - k)
            rejected = genome_size >= permutations or (
                1 - (1 - genome_size / permutations) ** ways) > 0.01
        out[(mismatches == k) & (aligned == n)] = rejected
    return out


def _counted(keys: np.ndarray, removed: np.ndarray, limit: int = SUBSAMPLING,
             held: int = 0, extra: int = 0) -> tuple:
    """(supporting reads, duplicates, mismatched reads) among the reads an
    event keeps, of its fragments in the order the program reads them (by
    name, so by id). The duplicate filter leaves the first fragment of
    each key, and later ones are duplicates; of the fragments it leaves,
    the mismatch filter takes those that removed marks. Past `limit`
    supporting reads no fragment is kept, past `limit` reads kept no
    filtered one (Arriba's -U subsampling: its lists stop there, and a
    filtered read they skip is named nowhere, so it leaves its key
    without support). held reads that other filters took sit in the list
    from the start; extra of them come among the fragments, taking the
    place of supporting reads (the two ends of where they can lie)."""
    seen: set = set()
    support = duplicates = mismatched = 0
    kept = held
    for key, gone in zip(keys.tolist(), removed.tolist()):
        duplicate = key in seen
        seen.add(key)
        filtered = duplicate or gone
        if support >= limit + extra or (filtered and kept >= limit):
            continue
        kept += 1
        support += not filtered
        duplicates += duplicate
        mismatched += filtered and not duplicate
    return min(support, limit), duplicates, mismatched


def expected_junctions(planted, layout) -> list:
    """Per planted junction: the breakpoint pair, the gene pair, the
    supporting split reads and discordant mates, the duplicates and the
    mismatched reads the event counts, the keys of its fragments in the
    order the program reads them (by name, so by id) with the mismatch
    filter's verdicts, and whether its support is strong."""
    out = []
    names, L = layout.contig_names, layout.read_length
    genome_size = int(layout.contig_lengths.sum())
    split, pairs = planted.split, planted.discordant
    split_key = split.anchor.astype(np.int64) * 1000 + split.gap
    # a split fragment: mate 1 and the supplementary's aligned part, whose
    # hard clip leads a reverse alignment and so counts no mismatch
    mm = planted.split_mismatches
    split_gone = (mismatch_rejects(mm[:, 0], np.full(len(mm), L), genome_size)
                  | mismatch_rejects(mm[:, 1], L - split.anchor, genome_size))
    mm = planted.discordant_mismatches
    full = np.full(len(mm), L)
    pair_gone = (mismatch_rejects(mm[:, 0], full, genome_size)
                 | mismatch_rejects(mm[:, 1], full, genome_size))
    for j in range(len(planted.bp1)):
        mine = np.flatnonzero(split.junction == j)
        mine = mine[np.argsort(split.fid[mine])]
        split_keys, split_removed = split_key[mine], split_gone[mine]
        mine = np.flatnonzero(pairs.junction == j)
        mine = mine[np.argsort(pairs.fid[mine])]
        disc_keys, disc_removed = pairs.pos1[mine], pair_gone[mine]
        n_split, split_dup, split_mm = _counted(split_keys, split_removed)
        n_disc, disc_dup, disc_mm = _counted(disc_keys, disc_removed)
        out.append({
            "keys": ((split_keys, split_removed), (disc_keys, disc_removed)),
            "breakpoints": frozenset((
                f"{names[planted.contig1[j]]}:{planted.bp1[j]}",
                f"{names[planted.contig2[j]]}:{planted.bp2[j] + 1}")),
            "genes": frozenset((f"GENE{planted.gene1[j]}",
                                f"GENE{planted.gene2[j]}")),
            "split": n_split, "discordant": n_disc,
            "duplicates": split_dup + disc_dup,
            "mismatches": split_mm + disc_mm,
            "strong": n_split + n_disc >= STRONG_SUPPORT})
    return out


def table_rows(text: bytes) -> list:
    lines = text.decode().rstrip("\n").split("\n")
    header = lines[0].lstrip("#").split("\t")
    return [dict(zip(header, line.split("\t"))) for line in lines[1:] if line]


def _by_breakpoints(rows: list) -> dict:
    out: dict = {}
    for row in rows:
        key = frozenset((row["breakpoint1"], row["breakpoint2"]))
        out.setdefault(key, []).append(row)
    return out


def _brief(row: dict) -> str:
    return " ".join(row.get(k, "?") for k in (
        "gene1", "gene2", "breakpoint1", "breakpoint2", "site1", "site2",
        "type", "split_reads1", "split_reads2", "discordant_mates",
        "filters"))


def table_checks(planted, layout, fusions: bytes,
                 discarded: bytes, details: list = None) -> dict:
    """Each planted junction is one event of the two tables with its genes
    and breakpoints; its support adds up, and its duplicates and
    mismatched reads are the planted ones; it is in fusions.tsv exactly where its filters name no
    event-level filter. A junction with strong support passes: its
    partners are sense fusions, spliced at both ends, of genes that share
    no sequence with any other, so no event-level filter of Arriba's
    applies to it (its e-value lies orders of magnitude under the
    cut-off, no read-through, intronic, end-to-end or no-coverage test
    reaches a spliced translocation, and the in-vitro test needs two
    split reads or fewer). Every other row of fusions.tsv lies at a
    planted junction's genes and has no split read (a breakpoint that
    discordant mates alone place): the lone artifacts, one read each, and
    the low-complexity segments never pass."""
    passed_rows = table_rows(fusions)
    passed = _by_breakpoints(passed_rows)
    events = _by_breakpoints(passed_rows + table_rows(discarded))
    rows_off = support_off = verdicts_off = 0
    planted_keys = set()
    planted_genes = set()
    for want in expected_junctions(planted, layout):
        key = want["breakpoints"]
        planted_keys.add(key)
        planted_genes.add(want["genes"])
        found = events.get(key, [])
        said = (f"junction {sorted(key)} {sorted(want['genes'])} split "
                f"{want['split']} discordant {want['discordant']} "
                f"duplicates {want['duplicates']} mismatches "
                f"{want['mismatches']}: ")
        if want["strong"] and key not in passed:
            verdicts_off += 1
            details.append(said + "strong, not passed: "
                           + " | ".join(_brief(r) for r in found))
        if len(found) != 1 or frozenset(
                (found[0]["gene1"], found[0]["gene2"])) != want["genes"]:
            rows_off += 1
            details.append(said + f"{len(found)} rows: "
                           + " | ".join(_brief(r) for r in found))
            continue
        row = found[0]
        entries = [e for e in row["filters"].split(",") if e and e != "."]
        removed = {name: int(count) for name, count in
                   FILTER_COUNT.findall(row["filters"])}
        split = int(row["split_reads1"]) + int(row["split_reads2"])
        discordant = int(row["discordant_mates"])
        others = sum(v for k, v in removed.items()
                     if k not in ("duplicates", "mismatches"))
        duplicates = removed.get("duplicates", 0)
        mismatched = removed.get("mismatches", 0)
        if not others:
            sound = (duplicates == want["duplicates"]
                     and mismatched == want["mismatches"]
                     and split == want["split"]
                     and discordant == want["discordant"])
        else:
            # reads that other filters took (low entropy, homopolymers:
            # the reference does not say which) are supporting reads the
            # row no longer counts, or reads the mismatch filter would
            # have taken; duplicates and mismatched reads lie between
            # where they can be
            low = [sum(_counted(*k, held=others)[i] for k in want["keys"])
                   for i in (1, 2)]
            high = [sum(_counted(*k, extra=others)[i] for k in want["keys"])
                    for i in (1, 2)]
            sound = (want["split"] + want["discordant"] - others
                     <= split + discordant
                     <= want["split"] + want["discordant"]
                     and min(low[0], want["duplicates"]) <= duplicates
                     <= max(high[0], want["duplicates"])
                     and min(low[1], want["mismatches"]) - others
                     <= mismatched <= max(high[1], want["mismatches"]))
        support_off += not sound
        if not sound:
            details.append(said + "support: " + _brief(row))
        if (len(removed) == len(entries)) != (key in passed):
            rows_off += 1
            details.append(said + "filters and table disagree: "
                           + _brief(row))
    for row in passed_rows:
        if frozenset((row["breakpoint1"], row["breakpoint2"])) \
                not in planted_keys and not (
                    frozenset((row["gene1"], row["gene2"])) in planted_genes
                    and int(row["split_reads1"])
                    + int(row["split_reads2"]) == 0):
            rows_off += 1
            details.append("passed at no planted junction: " + _brief(row))
    return {"junction_rows_off": _check(rows_off),
            "junction_verdicts_off": _check(verdicts_off),
            "junction_support_off": _check(support_off)}


# --------------------------------------------------------------------------
# K2: the low-entropy flags

def unpack_codes(packed: np.ndarray, L: int) -> np.ndarray:
    """[N, B] bytes of four 2-bit codes (low bits first) -> [N, L]."""
    shifts = np.array([0, 2, 4, 6], np.uint8)
    codes = (packed[:, :, None] >> shifts) & 3
    return codes.reshape(packed.shape[0], -1)[:, :L]


def le_threshold(segment_length: np.ndarray) -> np.ndarray:
    """filter_low_entropy.cpp's threshold: segment length times the
    maximum k-mer content over k in float32, plus 0.5 in double,
    truncated; a segment whose end lies before its start never trips."""
    q = (segment_length.astype(np.float32) * np.float32(KMER_CONTENT)) \
        / np.float32(LE_K)
    t = np.floor(q.astype(np.float64) + 0.5).astype(np.int64)
    return np.where(segment_length < 0, np.int64(1) << 40, t)


def low_entropy_flags(codes, meta, device="cpu"):
    """Arriba's low-entropy verdict of each row (bool numpy [N]): 3-mers
    counted without overlap (an occurrence counts unless the same 3-mer
    was counted at one of the two positions before it), at positions p
    with p + 3 < length, over the whole read and over each aligned segment
    [start, end) (p + 1 >= start and p < end); the read is low-entropy
    when a 3-mer's count reaches its threshold in any of the three. In
    plain PyTorch on device, a position at a time over every row."""
    import torch

    dev = torch.device(device)
    n, L = codes.shape
    meta = np.asarray(meta, np.int64)
    th = np.stack([le_threshold(meta[:, 0]), le_threshold(meta[:, 2]
                   - meta[:, 1]), le_threshold(meta[:, 4] - meta[:, 3])])
    length, s1, e1, s2, e2 = (torch.as_tensor(meta[:, k], device=dev)
                              for k in range(5))
    th = torch.as_tensor(th, device=dev)
    c = torch.as_tensor(np.asarray(codes, np.int64), device=dev)
    rows = torch.arange(n, device=dev)
    last = torch.full((n, 64), -LE_K, dtype=torch.int64, device=dev)
    counts = torch.zeros((3, n, 64), dtype=torch.int64, device=dev)
    for p in range(max(0, min(L, int(meta[:, 0].max(initial=0))) - LE_K)):
        kmer = (c[:, p] << 4) | (c[:, p + 1] << 2) | c[:, p + 2]
        counted = (p + LE_K < length) & (last[rows, kmer] <= p - LE_K)
        last[rows, kmer] = torch.where(counted, p, last[rows, kmer])
        for plane, inside in enumerate((
                counted, counted & (p + 1 >= s1) & (p < e1),
                counted & (p + 1 >= s2) & (p < e2))):
            counts[plane, rows, kmer] += inside.long()
    crossed = ((counts >= th[:, :, None]) & (counts[0] >= 1)).any(
        dim=2).any(dim=0)
    return (crossed & (length >= LE_K)).cpu().numpy()


def k2_checks(captures, device="cpu") -> dict:
    """Flags of the first sample's launches that differ from the
    reference's."""
    off = 0
    for (packed, L, meta), flags in zip(captures.k2_inputs, captures.k2[0]):
        packed = packed.cpu().numpy()
        meta = meta.cpu().numpy()
        want = low_entropy_flags(unpack_codes(packed, L), meta, device)
        off += int((want != flags.cpu().numpy().astype(bool)).sum())
    return {"low_entropy_flags_off": _check(off)}


def later_samples_differing(captures) -> list:
    """Per later sample: do its K2 flags or screen verdicts differ from
    the first sample's?"""
    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    out = []
    for k in range(1, len(captures.k2)):
        differ = False
        for log in (captures.k2, captures.screen, captures.accept):
            later, first = log[k], log[0]
            differ |= len(later) != len(first) or any(
                not np.array_equal(host(a), host(b))
                for a, b in zip(later, first))
        out.append(differ)
    return out


# --------------------------------------------------------------------------
# the mismapper screen: K5 and K1

# kmer_to_int's codes: T 0, G 1, C 2, any other byte 3
KMER_CODE = np.full(256, 3, np.int64)
KMER_CODE[ord("T")], KMER_CODE[ord("G")], KMER_CODE[ord("C")] = 0, 1, 2
COMPLEMENT = np.arange(256, dtype=np.uint8)
for _a, _b in ("AT", "TA", "CG", "GC", "at", "ta", "cg", "gc"):
    COMPLEMENT[ord(_a)] = ord(_b)


def _bytes(text) -> np.ndarray:
    if isinstance(text, str):
        text = text.encode("latin-1")
    return np.frombuffer(text, np.uint8)


def orientations(read) -> tuple:
    forward = _bytes(read)
    return forward, COMPLEMENT[forward[::-1]]


def kmers(seq: np.ndarray) -> np.ndarray:
    """The 8-mer values at each position of seq with 8 bytes from it."""
    n = len(seq) - SEED_K + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    code = KMER_CODE[seq]
    value = np.zeros(n, np.int64)
    for t in range(SEED_K):
        value = value * 4 + code[t:t + n]
    return value


def screen_verdicts(reads, window_of, windows) -> np.ndarray:
    out = np.zeros(len(reads), bool)
    for w in np.unique(window_of):
        table = np.unique(kmers(_bytes(windows[w])))
        for p in np.flatnonzero(window_of == w):
            found = False
            for seq in orientations(reads[p]):
                values = kmers(seq)
                at = np.searchsorted(table, values).clip(max=max(
                    len(table) - 1, 0))
                found |= bool(len(table) and (table[at] == values).any())
            out[p] = found
    return out


def accept_reference(rows: list, device="cpu", batch: int = 256) -> np.ndarray:
    """Does a single-seed alignment of each row's read (one orientation)
    in its window reach its minimum score? rows holds (read bytes, window
    bytes, min_score, seed_limit). Along each diagonal of the (read,
    window) grid: a seed is a run of 8 code matches (kmer_to_int codes)
    starting at read position i with i + 8 < len(read) and 2 i <=
    len(read) + 16 - min_score, at a window position j <= seed_limit whose
    byte is not 'N'; it scores 8 plus the byte matches to its left up to
    the second mismatch, and is accepted if that reaches min_score. From
    the seed's eighth base the diagonal walks right, +1 a byte match and
    -1 a mismatch, and ends after four mismatches in a row; it is accepted
    where it reaches min_score on a match. Evaluated a read position at a
    time over every diagonal of a batch of rows, in plain PyTorch."""
    out = np.zeros(len(rows), bool)
    for lo in range(0, len(rows), batch):
        out[lo:lo + batch] = _accept_batch(rows[lo:lo + batch], device)
    return out


def _accept_batch(rows: list, device) -> np.ndarray:
    import torch

    dev = torch.device(device)
    R = len(rows)
    Lmax = max(len(r) for r, _, _, _ in rows)
    Wmax = max(len(w) for _, w, _, _ in rows)
    if R == 0 or Lmax == 0 or Wmax == 0:
        return np.zeros(R, bool)
    reads = np.zeros((R, Lmax), np.uint8)
    windows = np.zeros((R, Wmax), np.uint8)
    for k, (r, w, _, _) in enumerate(rows):
        reads[k, :len(r)] = r
        windows[k, :len(w)] = w

    def column(values):
        return torch.as_tensor(np.asarray(values, np.int64),
                               device=dev)[:, None]

    Lr = column([len(r) for r, _, _, _ in rows])
    Wr = column([len(w) for _, w, _, _ in rows])
    ms = column([m for _, _, m, _ in rows])
    limit = column([s for _, _, _, s in rows])
    r = torch.as_tensor(reads.astype(np.int64), device=dev)
    w = torch.as_tensor(windows.astype(np.int64), device=dev)
    rc = torch.as_tensor(KMER_CODE[reads], device=dev)
    wc = torch.as_tensor(KMER_CODE[windows], device=dev)
    D = Wmax + Lmax     # diagonal d holds cells (i, j = i + d - Lmax)
    d = torch.arange(D, device=dev)
    zeros = torch.zeros((R, D), dtype=torch.int64, device=dev)
    a = b = q = bsave = cons = zeros
    sok = torch.zeros((R, D), dtype=torch.bool, device=dev)
    sc = torch.full((R, D), NEG, dtype=torch.int64, device=dev)
    accepted = torch.zeros(R, dtype=torch.bool, device=dev)
    for i in range(Lmax):
        j = (i + d - Lmax)[None, :]
        jj = j.clamp(0, Wmax - 1).expand(R, D)
        wj = torch.gather(w, 1, jj)
        valid = (j >= 0) & (j < Wr) & (i < Lr)
        m = valid & (wj == r[:, i:i + 1])
        cm = valid & (torch.gather(wc, 1, jj) == rc[:, i:i + 1])
        start = cm & (q == 0)
        eligible = ((i + SEED_K < Lr) & (2 * i <= Lr + 16 - ms)
                    & (j <= limit) & (wj != ord("N")))
        sok = torch.where(cm, torch.where(start, eligible, sok), False)
        bsave = torch.where(cm, torch.where(start, b, bsave), 0)
        a, b = torch.where(m, a + 1, 0), torch.where(
            valid, torch.where(m, b + 1, a), 0)
        q = torch.where(cm, q + 1, 0)
        cons = torch.where(valid, torch.where(m, 0, cons + 1), 0)
        fired = (q == SEED_K) & sok
        candidate = SEED_K + bsave
        step = torch.where(m, sc + 1, sc - 1)
        step = torch.where(valid & (torch.where(m, 0, cons) < 4), step, NEG)
        accepted |= ((m & (step >= ms)) | (fired & (candidate >= ms))).any(
            dim=1)
        sc = torch.maximum(step, torch.where(fired, candidate, NEG))
    return accepted.cpu().numpy()


def seed_limit(window_len: int, longest: int, window_chunk: int) -> int:
    """The last window position a seed may start at: the window cut into
    chunks of window_chunk bytes at a stride of window_chunk - 2 L (L the
    call's longest read rounded up to 64, at least 16), each chunk seeding
    its own stride and the first L - 1 bytes past it, a chunk past the
    first only where it holds L + 10 bytes or more, and no seed within 10
    bytes of the window's end."""
    L = -(-max(16, longest) // 64) * 64
    stride = window_chunk - 2 * L
    if window_len <= window_chunk:
        chunks = 1
    else:
        last = -(-(window_len - window_chunk) // stride)
        chunks = last + (window_len - last * stride >= L + 10)
    return min(window_len - 10, chunks * stride + L - 1)


def screen_checks(captures, device="cpu") -> dict:
    out = {}
    if not captures.screen or not captures.screen[0]:
        return out
    off = 0
    for inputs, got in zip(captures.screen_inputs, captures.screen[0]):
        want = screen_verdicts(inputs["reads"], inputs["window_of"],
                               inputs["windows"])
        off += int((want != got).sum())
    out["screen_verdicts_off"] = _check(off)
    rows, got_rows = [], []
    for inputs, got in zip(captures.accept_inputs, captures.accept[0]):
        for k, row in enumerate(inputs["rows"]):
            window = _bytes(inputs["windows"][inputs["window_of"][k]])
            limit = seed_limit(len(window), inputs["longest"],
                               inputs["window_chunk"])
            for seq in orientations(inputs["reads"][k]):
                rows.append((seq, window, int(inputs["min_scores"][k]),
                             limit))
            got_rows.append(bool(got[row]))
    want = accept_reference(rows, device).reshape(-1, 2).any(axis=1) \
        if rows else np.zeros(0, bool)
    off = int((want != np.array(got_rows, bool)).sum())
    out["accept_verdicts_off"] = _check(off)
    return out


# --------------------------------------------------------------------------

def check_run(run, planted, bg, first, differing: list,
              details: list = None) -> dict:
    """Every number compared, each with its limit. differing: per later
    sample, do its tables or counters differ from the first's? What the
    tables' numbers find off is described in details, where given."""
    layers = later_samples_differing(run.captures)
    off = sum(s.status != 0 or a or b for s, a, b in zip(
        run.samples[1:], differing, layers))
    checks = {"samples_off": _check(off + (run.samples[0].status != 0))}
    if first is None:
        checks["junction_rows_off"] = _check(len(planted.bp1))
        checks["junction_verdicts_off"] = _check(len(planted.bp1))
        return checks
    checks.update(table_checks(planted, bg.layout, first[0],
                               first[1], details))
    device = "cuda" if _on_card() else "cpu"
    checks.update(k2_checks(run.captures, device))
    checks.update(screen_checks(run.captures, device))
    return checks


def _on_card() -> bool:
    import torch
    return torch.cuda.is_available()
