"""The per-cell / per-position code the CUDA kernels run, on the CPU.

kernels/csrc/accept_wavefront.cuh, low_entropy.cuh and smith_waterman.cuh
hold the update functions K1, K2 and K3 call, as ``__host__ __device__``
code. Here g++ compiles them into a small harness that walks rows the way
the kernels do (K1: the seed lookup per strip of diagonals, the read's
8-mers in a bitmap, the window scan claiming each named diagonal once, then
a walk of each claimed diagonal, OR over them; and every diagonal walked,
for the per-diagonal soundness of the lookup;
K2: one sequential walk per read over its 2-bit-packed codes, and the
kernel's walk of a read from one byte pair per four positions into packed
counter words, tested once per 3-mer, or for wider rows the sequential
walk with three counters a 3-mer; K3: the 32 lanes of a warp over a pair of
rows in 16-bit halves, each lane a stripe of read positions, stepping over
the window columns with lane k taking lane k-1's previous word as the
shuffle does, with the host emulations of the 16x2 instructions), and the
results are held, exactly, against the port's plain PyTorch versions and
the JAX package's ops.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from arriba_tpu.ops import readfilters as jax_readfilters  # noqa: E402
from arriba_tpu.ops import realign as jax_realign  # noqa: E402
from arriba_tpu_torch.kernels.build import CSRC  # noqa: E402
from arriba_tpu_torch.ops import readfilters, realign  # noqa: E402
from chip_smoke import ACCEPT_KINDS, accept_adversarial_inputs  # noqa: E402

HARNESS = r"""
#include <stdint.h>
#include <algorithm>
#include <vector>
#include "accept_wavefront.cuh"
#include "low_entropy.cuh"
#include "smith_waterman.cuh"

// K3's warp for a pair of rows (b, wb null: the dummy row of an odd
// batch): every 128 steps each lane loads four columns of both windows;
// lane 0 takes column t from lane (t / 4) % 32's chunk, and lane k reads
// lane k-1's word of the previous step (lanes run from 31 down to 0, so
// that word is not yet replaced)
template <int S>
static void sw_pair(const uint8_t* a, const uint8_t* b, const uint8_t* wa,
                    const uint8_t* wb, int L, int W, int match, int mismatch,
                    int gap, int32_t* best_a, int32_t* best_b) {
    const arriba::SwScores sc = arriba::sw_scores(match, mismatch, gap);
    arriba::SwPair<S> lanes[32];
    uint32_t words[32], chunk[32];
    for (int k = 0; k < 32; ++k) {
        arriba::sw_pair_init<S>(&lanes[k], a, b, k * S, L, sc.gap2);
        words[k] = arriba::sw_window_word(arriba::SW_PAD, arriba::SW_PAD);
    }
    // the kernel runs the steps in fours
    const int n_steps = L > 0 ? (W + (L - 1) / S + 3) & ~3 : 0;
    for (int t = 0; t < n_steps; ++t) {
        if ((t & 127) == 0) {
            for (int k = 0; k < 32; ++k) {
                chunk[k] = arriba::sw_window_pair(wa, wb, t + 4 * k, W);
            }
        }
        const uint32_t pair = chunk[(t >> 2) & 31];
        for (int k = 31; k >= 0; --k) {
            const uint32_t in = k == 0 ? arriba::sw_lane0_word(pair, t)
                                       : words[k - 1];
            words[k] = arriba::sw_pair_column<S>(&lanes[k], in, sc);
        }
    }
    *best_a = *best_b = 0;
    for (int k = 0; k < 32; ++k) {
        *best_a = std::max(*best_a, (int)(lanes[k].best & 0xffffu));
        *best_b = std::max(*best_b, (int)(lanes[k].best >> 16));
    }
}

extern "C" {

// K1's work per row: every diagonal delta = j - i of the row, OR-reduced
void aw_rows(const uint8_t* reads, const uint8_t* windows,
             const int32_t* params, int32_t* out, int n, int L, int W) {
    for (int row = 0; row < n; ++row) {
        const int32_t* p = params + (long)row * 5;
        int accept = 0;
        for (int delta = -(L - 1); delta <= W - 1 && !accept; ++delta) {
            accept = arriba::aw_diagonal(reads + (long)row * L,
                                         windows + (long)row * W, delta,
                                         p[0], p[1], p[2], p[3], p[4]);
        }
        out[row] = accept;
    }
}

// K1's work per row as the kernel does it: per strip of diagonals, the
// read's seeds in the bitmap, the window stretch coded once, the scan
// claiming each named diagonal once, then the walks of the claimed ones.
// claims[row, delta + L - 1] (row stride L + W - 1) counts the claims of
// each diagonal; every strip is scanned, also after an accept.
void aw_rows_seeded(const uint8_t* reads, const uint8_t* windows,
                    const int32_t* params, int32_t* out, int32_t* claims,
                    int n, int L, int W) {
    int strip, n_strips;
    arriba::aw_strips(L, W, &strip, &n_strips);
    std::vector<uint32_t> bitmap(arriba::AW_BITMAP_WORDS);
    std::vector<uint32_t> claimed((strip + 31) / 32);
    std::vector<uint16_t> seeds(L > 0 ? L : 1);
    std::vector<uint8_t> codes(strip + L + 32);
    std::vector<int> queue;
    for (int row = 0; row < n; ++row) {
        const int32_t* p = params + (long)row * 5;
        const uint8_t* read = reads + (long)row * L;
        const uint8_t* window = windows + (long)row * W;
        const int read_len = std::min(std::max(p[0], 0), L);
        const int win_len = std::min(p[1], W);
        const int n_seeds = arriba::aw_seed_starts(read_len, p[2]);
        int lo, hi;
        arriba::aw_window_span(win_len, p[3], p[4], &lo, &hi);
        int accept = 0;
        for (int k = 0; k < n_strips; ++k) {
            const int d_lo = -(L - 1) + k * strip;
            const int d_hi = std::min(d_lo + strip, W) - 1;
            int jb, je;
            arriba::aw_scan_span(d_lo, d_hi, n_seeds, lo, hi, &jb, &je);
            if (jb > je) continue;
            std::fill(bitmap.begin(), bitmap.end(), 0u);
            std::fill(claimed.begin(), claimed.end(), 0u);
            for (int t = jb; t < je + arriba::AW_SEED; ++t) {
                codes[t - jb] = (uint8_t)arriba::aw_code_byte(window[t]);
            }
            for (int s = 0; s < n_seeds; ++s) {
                const int kmer = arriba::aw_kmer_raw(read + s);
                seeds[s] = (uint16_t)kmer;
                bitmap[kmer >> 5] |= 1u << (kmer & 31);
            }
            queue.clear();
            for (int j = jb; j <= je; ++j) {
                const int kmer = arriba::aw_window_seed(&codes[j - jb],
                                                        bitmap.data());
                if (kmer < 0) continue;
                int s_lo, s_hi;
                arriba::aw_seed_span(j, d_lo, d_hi, n_seeds, &s_lo, &s_hi);
                for (int s = s_lo; s <= s_hi; ++s) {
                    if (seeds[s] != kmer) continue;
                    const int bit = j - s - d_lo;
                    const uint32_t mask = 1u << (bit & 31);
                    if (claimed[bit >> 5] & mask) continue;
                    claimed[bit >> 5] |= mask;
                    queue.push_back(bit);
                    claims[(long)row * (L + W - 1) + d_lo + bit + L - 1] += 1;
                }
            }
            for (int bit : queue) {
                if (accept) break;
                accept = arriba::aw_diagonal(read, window, d_lo + bit,
                                             read_len, win_len, p[2], p[3],
                                             p[4]);
            }
        }
        out[row] = accept;
    }
}

// every diagonal of every row walked: accepts[row, delta + L - 1]
void aw_rows_diagonals(const uint8_t* reads, const uint8_t* windows,
                       const int32_t* params, uint8_t* accepts, int n, int L,
                       int W) {
    for (int row = 0; row < n; ++row) {
        const int32_t* p = params + (long)row * 5;
        for (int delta = -(L - 1); delta <= W - 1; ++delta) {
            accepts[(long)row * (L + W - 1) + delta + L - 1] =
                arriba::aw_diagonal(reads + (long)row * L,
                                    windows + (long)row * W, delta,
                                    std::min(std::max(p[0], 0), L),
                                    std::min(p[1], W), p[2], p[3], p[4]);
        }
    }
}

// K2's work per row, counters at stride 1
void le_rows(const uint8_t* packed, const int32_t* meta, uint8_t* out,
             int n, int row_bytes) {
    uint32_t counts[3 * arriba::LE_KMERS];
    for (int row = 0; row < n; ++row) {
        const int32_t* m = meta + (long)row * 8;
        out[row] = arriba::le_row(packed + (long)row * row_bytes, m[0], m[1],
                                  m[2], m[3], m[4], m[5], m[6], m[7], counts,
                                  1);
    }
}

// K2's work per row as the kernel does it, the route following the row
// width as the kernel's dispatch does: rows of at most 3,072 codes through
// le_scan_packed into 64 packed words and the test of each word, wider
// ones through le_row with three 32-bit counters a 3-mer
void le_rows_kernel(const uint8_t* packed, const int32_t* meta,
                    uint8_t* out, int n, int row_bytes) {
    const bool packed_route =
        4LL * row_bytes <= arriba::LE_PACKED_MAX_CODES;
    uint32_t words[64], counts[3 * arriba::LE_KMERS];
    for (int row = 0; row < n; ++row) {
        const int32_t* m = meta + (long)row * 8;
        const uint8_t* r = packed + (long)row * row_bytes;
        const int length = std::min(m[0], 4 * row_bytes);
        if (!packed_route) {
            out[row] = arriba::le_row(r, length, m[1], m[2], m[3], m[4],
                                      m[5], m[6], m[7], counts, 1);
            continue;
        }
        const int n_pos = std::max(length - arriba::LE_K, 0);
        std::fill(words, words + 64, 0u);
        arriba::le_scan_packed(r, row_bytes, n_pos,
                               arriba::le_segment(m[1], m[2], n_pos),
                               arriba::le_segment(m[3], m[4], n_pos),
                               [&](int v, uint32_t w) { words[v] += w; });
        bool flagged = false;
        for (int v = 0; v < 64; ++v) {
            flagged |= arriba::le_crossed_packed(words[v], m[5], m[6], m[7]);
        }
        out[row] = flagged;
    }
}

// K3's work per pair of rows, with the stripe the kernel's dispatch picks;
// an odd n pairs the last row with the all-PAD dummy
void sw_rows(const uint8_t* reads, const uint8_t* windows, int32_t* out,
             int n, int L, int W, int match, int mismatch, int gap) {
    const int stripe = (L + 31) / 32;
    for (int row = 0; row < n; row += 2) {
        const bool has_b = row + 1 < n;
        const uint8_t* a = reads + (long)row * L;
        const uint8_t* b = has_b ? a + L : nullptr;
        const uint8_t* wa = windows + (long)row * W;
        const uint8_t* wb = has_b ? wa + W : nullptr;
        int32_t dummy;
        int32_t* out_b = has_b ? &out[row + 1] : &dummy;
        auto pair = stripe <= 1 ? sw_pair<1> : stripe <= 2 ? sw_pair<2>
                  : stripe <= 4 ? sw_pair<4> : stripe <= 8 ? sw_pair<8>
                  : sw_pair<16>;
        pair(a, b, wa, wb, L, W, match, mismatch, gap, &out[row], out_b);
    }
}

// K3's 16x2 primitives as the host emulation computes them: 0 add.s16x2,
// 1 max.s16x2, 2 the DPX add+max.relu, 3 prmt
uint32_t sw_primitive(int which, uint32_t a, uint32_t b, uint32_t c) {
    switch (which) {
    case 0: return arriba::sw_add2(a, b);
    case 1: return arriba::sw_max2(a, b);
    case 2: return arriba::sw_addmax_relu2(a, b, c);
    default: return arriba::sw_perm(a, b, c);
    }
}

}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("g++ is not installed: the kernels' update functions "
                    "cannot be compiled for the CPU")
    work = tmp_path_factory.mktemp("kernel_math")
    source = work / "harness.cpp"
    source.write_text(HARNESS)
    library = work / "libharness.so"
    subprocess.run([compiler, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", str(source), "-o", str(library)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(library))
    lib.aw_rows.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    lib.aw_rows_seeded.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    lib.aw_rows_diagonals.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    lib.le_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.le_rows_kernel.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.sw_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    lib.sw_primitive.argtypes = [ctypes.c_int] + [ctypes.c_uint32] * 3
    lib.sw_primitive.restype = ctypes.c_uint32
    return lib


def _ptr(array):
    return array.ctypes.data_as(ctypes.c_void_p)


def _accept_rows(seed, N, L, W):
    """(reads, windows, params): embedded read copies with a few mutations,
    random rejects, 'N' bytes, short win_len and per-row seed ranges."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    reads = np.zeros((N, L), np.uint8)
    windows = np.ones((N, W), np.uint8)
    params = np.zeros((N, 5), np.int32)
    for row in range(N):
        read_len = int(rng.integers(20, L + 1))
        win_len = int(rng.integers(read_len, W + 1))
        window = alphabet[rng.choice(5, win_len, p=[.24, .24, .24, .24, .04])]
        read = alphabet[rng.integers(0, 4, read_len)]
        if row % 3 != 2:  # embedded copy, mutated a little
            start = int(rng.integers(0, win_len - read_len + 1))
            read = window[start:start + read_len].copy()
            flips = rng.integers(0, read_len, int(rng.integers(0, 6)))
            read[flips] = alphabet[rng.integers(0, 4, len(flips))]
            if row % 3 == 1:  # a run of 3-5 mismatches: the walk's break
                run = int(rng.integers(3, 6))
                at = int(rng.integers(read_len // 4, read_len // 2))
                read[at:at + run] = np.where(read[at:at + run] == ord("A"),
                                             ord("C"), ord("A"))
        reads[row, :read_len] = read
        windows[row, :win_len] = window
        ms = int(0.8 * read_len + 0.5) - int(rng.integers(0, 3)) * (row % 2)
        lo = int(rng.integers(-5, 40)) if row % 4 == 1 else 0
        hi = int(rng.integers(lo, win_len + 20)) if row % 4 == 1 else win_len
        params[row] = (read_len, win_len, ms, lo, hi)
    return reads, windows, params


# the second shape has reads longer than 511 bytes: the counters stay
# unpacked, so nothing wraps
@pytest.mark.parametrize("seed,N,L,W", [(17, 24, 128, 512), (5, 4, 576, 640)])
def test_accept_cell_update_matches_plain_and_jax(harness, seed, N, L, W):
    reads, windows, params = _accept_rows(seed, N, L, W)
    native = np.zeros(N, np.int32)
    harness.aw_rows(_ptr(reads), _ptr(windows), _ptr(params), _ptr(native),
                    N, L, W)
    plain = realign.accept_wavefront(torch.from_numpy(reads),
                                     torch.from_numpy(windows),
                                     torch.from_numpy(params)).numpy()
    xla = np.asarray(jax_realign._accept_wavefront_kernel(
        jnp.asarray(reads), jnp.asarray(windows),
        *(jnp.asarray(params[:, c]) for c in range(5))))
    np.testing.assert_array_equal(native != 0, plain)
    np.testing.assert_array_equal(plain, xla)
    assert 0 < plain.sum() < N


def _strip_edge_rows(seed, L, W):
    """Rows whose only seed names a diagonal at an edge of a block's strip
    (the first and last diagonal of each strip, the lowest diagonal that
    reaches window byte 0): the read suffix from its first or its last
    eligible start s, copied onto that diagonal after a code mismatch; from
    s = 0, code mismatches every 8 bytes break every later eligible seed.
    Every row accepts."""
    rng = np.random.default_rng(seed)
    base = np.frombuffer(b"ACGT", np.uint8)
    d = L + W - 1
    n = -(-d // 2048)
    strip = -(-(-(-d // n)) // 32) * 32
    read_len = L - 28
    ms = int(0.8 * read_len + 0.5)
    s_max = min((read_len + 16 - ms) // 2 + 1, read_len - 8) - 1
    edges = [-s_max] + [-(L - 1) + k * strip + e for k in range(1, n)
                        for e in (-1, 0)]
    rows = [(s, delta) for delta in edges for s in (0, s_max)
            if delta + s >= 0]
    reads = np.zeros((len(rows), L), np.uint8)
    windows = np.ones((len(rows), W), np.uint8)
    params = np.zeros((len(rows), 5), np.int32)
    for row, (s, delta) in enumerate(rows):
        read = base[rng.integers(0, 4, read_len)]
        window = base[rng.integers(0, 4, W)]
        window[delta + s:delta + read_len] = read[s:]
        other = np.where(read == ord("T"), ord("G"), ord("T"))
        if s > 0:
            window[delta + s - 1] = other[s - 1]
        else:
            cuts = np.arange(8, s_max + 9, 8)
            window[delta + cuts] = other[cuts]
        reads[row, :read_len] = read
        windows[row] = window
        params[row] = (read_len, W, ms, 0, W)
    return reads, windows, params


# the shapes above, the adversarial rows (two of each kind) at a small
# shape, and seeds at the edges of the strips of a window of two strips
_AW_CASES = {
    "embedded": lambda: _accept_rows(17, 24, 128, 512),
    "long_reads": lambda: _accept_rows(5, 4, 576, 640),
    "adversarial": lambda: accept_adversarial_inputs(
        N=2 * len(ACCEPT_KINDS), L=128, W=512),
    "strip_edges": lambda: _strip_edge_rows(7, 128, 2600),
}


def _seed_lookup(harness, reads, windows, params):
    """K1's per-row procedure under g++: (verdicts, claims [N, L + W - 1])."""
    (N, L), W = reads.shape, windows.shape[1]
    verdicts = np.zeros(N, np.int32)
    claims = np.zeros((N, L + W - 1), np.int32)
    harness.aw_rows_seeded(_ptr(reads), _ptr(windows), _ptr(params),
                           _ptr(verdicts), _ptr(claims), N, L, W)
    return verdicts != 0, claims


@pytest.mark.parametrize("case", list(_AW_CASES))
def test_accept_seed_lookup_matches_plain_and_jax(harness, case):
    reads, windows, params = _AW_CASES[case]()
    seeded, claims = _seed_lookup(harness, reads, windows, params)
    plain = realign.accept_wavefront(torch.from_numpy(reads),
                                     torch.from_numpy(windows),
                                     torch.from_numpy(params)).numpy()
    xla = np.asarray(jax_realign._accept_wavefront_kernel(
        jnp.asarray(reads), jnp.asarray(windows),
        *(jnp.asarray(params[:, c]) for c in range(5))))
    np.testing.assert_array_equal(seeded, plain)
    np.testing.assert_array_equal(plain, xla)
    assert claims.max() <= 1        # each diagonal is walked at most once
    if case == "adversarial":
        want = [ACCEPT_KINDS[row % len(ACCEPT_KINDS)][1]
                for row in range(len(reads))]
        np.testing.assert_array_equal(plain, want)
    elif case == "strip_edges":
        assert plain.all()
    else:
        assert 0 < plain.sum() < len(reads)


@pytest.mark.parametrize("case", list(_AW_CASES))
def test_every_accepting_diagonal_is_a_seed_candidate(harness, case):
    """Soundness of the lookup, diagonal by diagonal: aw_diagonal accepts
    no diagonal that the seed lookup leaves unwalked."""
    reads, windows, params = _AW_CASES[case]()
    (N, L), W = reads.shape, windows.shape[1]
    accepts = np.zeros((N, L + W - 1), np.uint8)
    harness.aw_rows_diagonals(_ptr(reads), _ptr(windows), _ptr(params),
                              _ptr(accepts), N, L, W)
    _, claims = _seed_lookup(harness, reads, windows, params)
    accepts = accepts != 0
    assert accepts.any()
    assert not (accepts & (claims == 0)).any()
    # the walks of every diagonal OR to the plain version's verdict
    plain = realign.accept_wavefront(torch.from_numpy(reads),
                                     torch.from_numpy(windows),
                                     torch.from_numpy(params)).numpy()
    np.testing.assert_array_equal(accepts.any(axis=1), plain)


def _low_entropy_rows(seed, n, L):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, (n, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, n).astype(np.int32)
    a1s = rng.integers(-3, L, n).astype(np.int32)
    a1e = (a1s + rng.integers(-10, L, n)).astype(np.int32)  # some inverted
    a2s = rng.integers(0, L, n).astype(np.int32)
    a2e = (a2s + rng.integers(0, L, n)).astype(np.int32)
    for row in range(0, n, 4):  # repeat a short motif: low entropy
        motif = rng.integers(0, 4, int(rng.integers(1, 4)))
        codes[row] = np.tile(motif, L)[:L]
        lengths[row] = int(rng.integers(L // 2, L + 1))
    for row in range(1, n, 4):  # a low-entropy stretch around segment 1
        lengths[row] = L
        a1s[row] = int(rng.integers(2, L // 2))
        a1e[row] = a1s[row] + int(rng.integers(12, L // 2))
        lo = a1s[row] - int(rng.integers(0, 3))
        hi = a1e[row] + int(rng.integers(0, 3))
        codes[row, lo:hi] = np.tile(rng.integers(0, 4, 1), hi - lo)
    return codes, lengths, a1s, a1e, a2s, a2e


@pytest.mark.parametrize("kmer_content", [0.6, 0.3])
def test_low_entropy_position_update_matches_plain_and_jax(harness,
                                                           kmer_content):
    codes, lengths, a1s, a1e, a2s, a2e = _low_entropy_rows(3, 256, 150)
    th = readfilters._thresholds(lengths, a1s, a1e, a2s, a2e, kmer_content)
    meta = np.ascontiguousarray(np.stack(
        [lengths, a1s, a1e, a2s, a2e, *th], axis=1).astype(np.int32))
    packed = np.ascontiguousarray(readfilters.pack_codes(codes))
    native = np.zeros(len(codes), np.uint8)
    harness.le_rows(_ptr(packed), _ptr(meta), _ptr(native), len(codes),
                    packed.shape[1])
    plain = readfilters.low_entropy_batch(
        *(torch.from_numpy(x) for x in (codes, lengths, a1s, a1e, a2s, a2e)),
        kmer_content).numpy()
    xla = np.asarray(jax_readfilters.low_entropy_batch(
        *(jnp.asarray(x) for x in (codes, lengths, a1s, a1e, a2s, a2e)),
        kmer_content))
    np.testing.assert_array_equal(native != 0, plain)
    np.testing.assert_array_equal(plain, xla)
    assert 0 < plain.sum() < len(codes)


def _low_entropy_edge_rows(seed, n, L):
    """_low_entropy_rows plus rows at the edges: lengths 0-4 and L,
    segments starting before the read or past its end, ending past it, and
    inverted, and homopolymer rows of the full width."""
    codes, lengths, a1s, a1e, a2s, a2e = (
        np.concatenate([x, np.resize(x, (24,) + x.shape[1:])])
        for x in _low_entropy_rows(seed, n, L))
    edge = np.arange(n, n + 24)
    lengths[edge[:6]] = [0, 1, 2, 3, 4, L]
    codes[edge[6:12]] = int(seed) % 4                   # homopolymers
    lengths[edge[6:12]] = L
    a1s[edge[6:]] = np.resize([-7, 0, L - 2, L + 5, 3, 1], 18)
    a1e[edge[6:]] = np.resize([L + 9, L, L + 1, L + 9, 2, L // 2], 18)
    a2s[edge[12:]] = np.resize([L // 3, -1, L], 12)
    a2e[edge[12:]] = np.resize([L // 3, L // 2, L + 3], 12)
    return codes, lengths, a1s, a1e, a2s, a2e


def _low_entropy_through(harness, rows, kmer_content):
    """K2's per-row procedure (le_rows_kernel), the plain version and the
    JAX package on the same rows; all must agree. Returns the flags."""
    codes, lengths, a1s, a1e, a2s, a2e = rows
    th = readfilters._thresholds(lengths, a1s, a1e, a2s, a2e, kmer_content)
    meta = np.ascontiguousarray(np.stack(
        [lengths, a1s, a1e, a2s, a2e, *th], axis=1).astype(np.int32))
    packed = np.ascontiguousarray(readfilters.pack_codes(codes))
    plain = readfilters.low_entropy_batch(
        *(torch.from_numpy(x) for x in rows), kmer_content).numpy()
    xla = np.asarray(jax_readfilters.low_entropy_batch(
        *(jnp.asarray(x) for x in rows), kmer_content))
    np.testing.assert_array_equal(plain, xla)
    native = np.zeros(len(codes), np.uint8)
    harness.le_rows_kernel(_ptr(packed), _ptr(meta), _ptr(native),
                           len(codes), packed.shape[1])
    np.testing.assert_array_equal(native != 0, plain)
    return plain


# widths on and off a multiple of four codes (whole byte pairs, then the
# rest one at a time), from a few byte pairs to a few hundred
@pytest.mark.parametrize("L", [150, 37, 149, 64, 511, 1021])
@pytest.mark.parametrize("kmer_content", [0.6, 0.3])
def test_low_entropy_packed_kernel_matches_plain_and_jax(harness, L,
                                                         kmer_content):
    plain = _low_entropy_through(harness, _low_entropy_edge_rows(3, 256, L),
                                 kmer_content)
    assert 0 < plain.sum() < len(plain)
    assert not plain[256:259].any()      # lengths 0-2 never flag


# 3,072 codes: the packed counters' widest rows (a homopolymer selects its
# 3-mer 1,023 times); 3,100: the route with three counters a 3-mer
@pytest.mark.parametrize("L", [3072, 3100])
def test_low_entropy_long_rows_match_plain_and_jax(harness, L):
    plain = _low_entropy_through(harness, _low_entropy_edge_rows(5, 8, L),
                                 0.6)
    assert 0 < plain.sum() < len(plain)


# stripes of 1, 2, 4, 8 and 16 read positions a lane; L not a multiple of 32
# and W < L among them
@pytest.mark.parametrize("seed,n,L,W", [(1, 12, 20, 50), (2, 12, 37, 300),
                                        (3, 10, 100, 64), (4, 8, 256, 256),
                                        (5, 4, 300, 180)])
def test_smith_waterman_cell_update_matches_plain_and_jax(harness, seed, n,
                                                          L, W):
    from .test_torch_realign import _sw_rows

    reads, windows = _sw_rows(seed, n, L, W)
    for match, mismatch, gap in ((1, -1, -1), (2, -3, -2)):
        native = np.zeros(n, np.int32)
        harness.sw_rows(_ptr(reads), _ptr(windows), _ptr(native), n, L, W,
                        match, mismatch, gap)
        plain = realign.smith_waterman_scores(
            torch.from_numpy(reads), torch.from_numpy(windows), match,
            mismatch, gap).numpy()
        np.testing.assert_array_equal(native, plain)
    xla = np.asarray(jax_realign.smith_waterman_scores(
        jnp.asarray(reads), jnp.asarray(windows), match, mismatch, gap))
    np.testing.assert_array_equal(plain, xla)
    assert plain.min() == 0 and plain.max() > 8


# odd batches (the last row beside the all-PAD dummy), a one-row batch, PAD
# inside reads and windows, both score sets, and each row in either half:
# the batch reversed pairs every row with another partner
@pytest.mark.parametrize("seed,n,L,W", [(6, 13, 37, 300), (7, 1, 256, 256),
                                        (8, 7, 100, 64)])
def test_smith_waterman_pair_warp_odd_batches(harness, seed, n, L, W):
    from arriba_tpu_torch.ops.encode import PAD_CODE

    from .test_torch_realign import _sw_rows

    reads, windows = _sw_rows(seed, n + 2, L, W)
    reads, windows = reads[:n].copy(), windows[:n].copy()
    rng = np.random.default_rng(seed)
    reads[rng.random(reads.shape) < 0.02] = PAD_CODE
    windows[rng.random(windows.shape) < 0.02] = PAD_CODE
    for match, mismatch, gap in ((1, -1, -1), (2, -3, -2)):
        plain = realign.smith_waterman_scores(
            torch.from_numpy(reads), torch.from_numpy(windows), match,
            mismatch, gap).numpy()
        for order in (slice(None), slice(None, None, -1)):
            r = np.ascontiguousarray(reads[order])
            w = np.ascontiguousarray(windows[order])
            native = np.zeros(n, np.int32)
            harness.sw_rows(_ptr(r), _ptr(w), _ptr(native), n, L, W, match,
                            mismatch, gap)
            np.testing.assert_array_equal(native, plain[order])
    xla = np.asarray(jax_realign.smith_waterman_scores(
        jnp.asarray(reads), jnp.asarray(windows), match, mismatch, gap))
    np.testing.assert_array_equal(plain, xla)
    assert plain.max() > 8


def _halves(x):
    return [int(np.int16(np.uint16((x >> (16 * k)) & 0xFFFF)))
            for k in (0, 1)]


def _word(lo, hi):
    return (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)


def _wrap16(x):
    return int(np.int16(np.uint16(x & 0xFFFF)))


# per-halfword scalar math of each 16x2 primitive
_SW_PRIMITIVES = {
    "add.s16x2": (0, lambda a, b, c: _wrap16(a + b)),
    "max.s16x2": (1, lambda a, b, c: max(a, b)),
    "viaddmax_s16x2_relu": (2, lambda a, b, c: max(_wrap16(a + b), c, 0)),
}
_EDGE_HALVES = [0, 1, -1, 2, -2, 127, -128, 8191, -8192, 16383, -16384,
                32767, -32768]


@pytest.mark.parametrize("name", list(_SW_PRIMITIVES) + ["prmt"])
def test_smith_waterman_primitive_emulation(harness, name):
    """Each 16x2 primitive's host emulation against per-halfword scalar
    math on random and edge halves; prmt against its byte selection with
    sign replication, and on the selectors and score tables K3 builds."""
    rng = np.random.default_rng(11)
    halves = _EDGE_HALVES + rng.integers(-32768, 32768, 40).tolist()
    words = [_word(lo, hi) for lo in _EDGE_HALVES for hi in halves[::3]]
    words += [int(x) for x in rng.integers(0, 1 << 32, 200, np.uint64)]
    if name != "prmt":
        which, scalar = _SW_PRIMITIVES[name]
        for k in range(300):
            a, b, c = (words[(k * m + j) % len(words)]
                       for m, j in ((7, 0), (11, 3), (13, 5)))
            got = harness.sw_primitive(which, a, b, c)
            want = [scalar(x, y, z) for x, y, z in zip(
                _halves(a), _halves(b), _halves(c))]
            assert _halves(got) == want, (name, hex(a), hex(b), hex(c))
        return
    selectors = [int(x) for x in rng.integers(0, 1 << 16, 200)]
    # K3's selectors: read codes 0-4 of both rows
    selectors += [ca | ((ca | 8) << 4) | ((cb | 4) << 8) | ((cb | 12) << 12)
                  for ca in range(5) for cb in range(5)]
    for k, sel in enumerate(selectors):
        lo, hi = words[k % len(words)], words[(3 * k + 1) % len(words)]
        data = lo | (hi << 32)
        want = 0
        for i in range(4):
            n = (sel >> (4 * i)) & 0xF
            byte = (data >> (8 * (n & 7))) & 0xFF
            if n & 8:
                byte = 0xFF if byte & 0x80 else 0
            want |= byte << (8 * i)
        assert harness.sw_primitive(3, lo, hi, sel) == want
    # the score table picks s - gap, sign-extended, for each code pair
    for match, mismatch, gap in ((1, -1, -1), (2, -3, -2), (5, -100, 20)):
        mis = (mismatch - gap) & 0xFF
        flip = ((match - gap) & 0xFF) ^ mis
        for wa in range(4):
            for wb in range(4):
                t0 = (mis * 0x01010101) ^ (flip << (8 * wa))
                t1 = (mis * 0x01010101) ^ (flip << (8 * wb))
                for ca in range(4):
                    for cb in range(4):
                        sel = (ca | ((ca | 8) << 4) | ((cb | 4) << 8)
                               | ((cb | 12) << 12))
                        got = _halves(harness.sw_primitive(3, t0, t1, sel))
                        assert got == [
                            (match if ca == wa else mismatch) - gap,
                            (match if cb == wb else mismatch) - gap]


@pytest.mark.parametrize("L,W,params,ok", [
    (256, 256, (1, -1, -1), True),
    (512, 8192, (15, -1, -1), True),     # 15 * 512 = 7680 < 2^13
    (512, 256, (16, -1, -1), False),     # 16 * 512 = 8192
    (513, 256, (1, -1, -1), False),      # past 16 positions a lane
    (256, 256, (1, -129, -1), True),     # mismatch - gap = -128
    (256, 256, (1, -130, -1), False),    # -129
    (256, 256, (1, -1, 1), True),        # 256 + 512 < 2^13
    (512, 8192, (1, -1, 1), False),      # +1 a gap over L + W
    (100, 20, (1, -200, -200), False),   # match - gap = 201
    (10, 10, (-20000, -20000, -20000), False),  # |gap| > 2^14
])
def test_smith_waterman_guard(L, W, params, ok):
    """K3's 16-bit guard, decided from shapes and scores alone: a refused
    call raises ValueError before anything reaches the card."""
    from arriba_tpu_torch import kernels

    if ok:
        kernels.sw_guard(L, W, *params)
    else:
        with pytest.raises(ValueError):
            kernels.sw_guard(L, W, *params)
