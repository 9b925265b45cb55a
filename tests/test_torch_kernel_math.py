"""The per-cell / per-position code the CUDA kernels run, on the CPU.

kernels/csrc/accept_wavefront.cuh, low_entropy.cuh and smith_waterman.cuh
hold the update functions K1, K2 and K3 call, as ``__host__ __device__``
code. Here g++ compiles them into a small harness that walks rows the way
the kernels do (K1: one independent walk per diagonal, OR over diagonals;
K2: one sequential walk per read over its 2-bit-packed codes; K3: the 32
lanes of a warp, each a stripe of read positions, stepping over the window
columns with lane k taking lane k-1's previous output as the shuffle does),
and the results are held, exactly, against the port's plain PyTorch
versions and the JAX package's ops.
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

HARNESS = r"""
#include <stdint.h>
#include "accept_wavefront.cuh"
#include "low_entropy.cuh"
#include "smith_waterman.cuh"

// K3's warp for one row: lane k reads lane k-1's output of the previous
// step (lanes run from 31 down to 0, so that output is not yet replaced)
template <int S>
static int sw_row(const uint8_t* read, const uint8_t* window, int L, int W,
                  int match, int mismatch, int gap) {
    arriba::SwLane<S> lanes[32];
    int packed[32];
    for (int k = 0; k < 32; ++k) {
        arriba::sw_lane_init<S>(&lanes[k], read, k * S, L);
        packed[k] = arriba::SW_PAD;
    }
    const int n_steps = L > 0 ? W + (L - 1) / S : 0;
    for (int t = 0; t < n_steps; ++t) {
        for (int k = 31; k >= 0; --k) {
            const int up = k == 0 ? 0 : packed[k - 1] >> 8;
            const int w = k == 0 ? (t < W ? window[t] : arriba::SW_PAD)
                                 : packed[k - 1] & 0xff;
            const int h = arriba::sw_lane_column<S>(&lanes[k], up, w, match,
                                                    mismatch, gap);
            packed[k] = (h << 8) | w;
        }
    }
    int best = 0;
    for (int k = 0; k < 32; ++k) best = lanes[k].best > best ? lanes[k].best
                                                             : best;
    return best;
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

// K2's work per row, counters at stride 1
void le_rows(const uint8_t* packed, const int32_t* meta, uint8_t* out,
             int n, int row_bytes) {
    uint16_t counts[3 * arriba::LE_KMERS];
    for (int row = 0; row < n; ++row) {
        const int32_t* m = meta + (long)row * 8;
        out[row] = arriba::le_row(packed + (long)row * row_bytes, m[0], m[1],
                                  m[2], m[3], m[4], m[5], m[6], m[7], counts,
                                  1);
    }
}

// K3's work per row, with the stripe the kernel's dispatch picks
void sw_rows(const uint8_t* reads, const uint8_t* windows, int32_t* out,
             int n, int L, int W, int match, int mismatch, int gap) {
    const int stripe = (L + 31) / 32;
    for (int row = 0; row < n; ++row) {
        const uint8_t* r = reads + (long)row * L;
        const uint8_t* w = windows + (long)row * W;
        out[row] = stripe <= 1 ? sw_row<1>(r, w, L, W, match, mismatch, gap)
                 : stripe <= 2 ? sw_row<2>(r, w, L, W, match, mismatch, gap)
                 : stripe <= 4 ? sw_row<4>(r, w, L, W, match, mismatch, gap)
                 : stripe <= 8 ? sw_row<8>(r, w, L, W, match, mismatch, gap)
                 : sw_row<16>(r, w, L, W, match, mismatch, gap);
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
    lib.le_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.sw_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
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
