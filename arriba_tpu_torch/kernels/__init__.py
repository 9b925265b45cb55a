"""Hand-written CUDA kernels (sm_90a) and their PyTorch-facing wrappers.

Each ``launch_*`` function takes CUDA tensors only, checks device, type,
shape and contiguity (tensor metadata, so it never waits for the card),
launches on PyTorch's current stream into an output the caller allocated,
and raises if the launch returned a CUDA error. It adds one to
``launch_counts[name]`` where it launches, and nowhere else, so a run can
show that its main path went through the kernel; a kernel with a second
variant counts it under its own name (``accept_wavefront_indexed``,
``low_entropy_long``, ``smith_waterman_wide16``, ``smith_waterman_wide``,
``mxu_kmer_screen_any_k``), and K5's two passes (kb_passes, each launch
checked) count once a screen, as ``kmer_bitmap_screen``. The value ranges of
the row lengths and offsets are checked on the host where the callers
build them; the kernels clamp those lengths to their rows and skip a row
whose offsets leave its tables, so no value can make them read outside
their inputs.

The card answers every input the JAX ops answer. Where one kernel cannot
carry an input exactly, the wrapper routes it to another hand kernel
before launch, from shapes, parameters and the byte range: K3's 16-bit
pairs take what passes ``sw_guard`` and ``sw_codes_guard``; K3w, tiled
over the read, takes reads past 512 positions in the same 16-bit pairs
where only the length stops K3, and in 32-bit lanes (any byte) the rest
(``sw_route``; each route names its ``launch_*`` function); K4 takes k = 8
and its any-k kernel every other k; K1 decides per row, inside the
kernel, between its seed lookup and a walk of every diagonal. What is
still refused is what would wrap the JAX op's own int32 arithmetic
(``sw_wide_guard``) or what the JAX op itself fails on (k < 1).
``accept_wavefront``, ``accept_wavefront_indexed``,
``kmer_bitmap_screen``, ``low_entropy``, ``smith_waterman`` and
``mxu_kmer_screen`` allocate the output and return bool verdicts (int32
scores for ``smith_waterman``). The plain PyTorch versions (the CPU path
and the reference the kernels are held against) live beside their callers
in ``ops/``.
"""

from __future__ import annotations

launch_counts = {"accept_wavefront": 0, "accept_wavefront_indexed": 0,
                 "kmer_bitmap_screen": 0, "low_entropy": 0,
                 "low_entropy_long": 0, "smith_waterman": 0,
                 "smith_waterman_wide16": 0, "smith_waterman_wide": 0,
                 "mxu_kmer_screen": 0, "mxu_kmer_screen_any_k": 0,
                 "bgzf_inflate": 0, "bam_frame": 0, "bam_pairs": 0,
                 "bam_residue": 0, "bam_coverage_finish": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _require(tensor, name: str, dtype, ndim: int) -> None:
    if not tensor.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if tensor.dtype != dtype or tensor.dim() != ndim:
        raise ValueError(f"{name} must be {dtype} with {ndim} dims, got "
                         f"{tensor.dtype} {tuple(tensor.shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _call(name: str, *args) -> None:
    """Launch the C entry point ``name`` (kernels.build) on the current
    stream, a tensor argument as its data_ptr; raise on a CUDA error."""
    import torch

    from .build import load

    launch, error_string = load(name)
    values = [x.data_ptr() if hasattr(x, "data_ptr") else x for x in args]
    code = launch(*values, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"{error_string(code)} ({code})")


def _launch(name: str, *args) -> None:
    """Launch the C entry point ``name`` (_call) and count it."""
    _call(name, *args)
    launch_counts[name] += 1


def launch_accept_wavefront(reads, windows, params, out) -> None:
    """K1 (csrc/accept_wavefront.cu) into out, int32 [N] zeros: a row's
    entry becomes non-zero when it accepts. reads uint8 [N, L] (pad byte
    0), windows uint8 [N, W] (pad byte 1), params int32 [N, 5] =
    (read_len, win_len, min_score, seed_lo, seed_hi) with
    0 <= read_len <= L and win_len <= W; any min_score and any N. A row
    with min_score > read_len - 2^20 walks only the diagonals a seed names
    (without a fired seed a walk scores at most read_len - 2^20); any
    other row walks every diagonal."""
    import torch

    _require(reads, "reads", torch.uint8, 2)
    _require(windows, "windows", torch.uint8, 2)
    _require(params, "params", torch.int32, 2)
    _require(out, "out", torch.int32, 1)
    n, L = reads.shape
    W = windows.shape[1]
    if (windows.shape[0] != n or tuple(params.shape) != (n, 5)
            or out.shape[0] != n):
        raise ValueError("reads, windows, params and out must have the same "
                         "rows and params 5 columns")
    _launch("accept_wavefront", reads.data_ptr(), windows.data_ptr(),
            params.data_ptr(), out.data_ptr(), n, L, W)


# the window table bytes K1's indexed entry reads past the last window's
# end (csrc/accept_wavefront.cuh AW_TABLE_SLACK)
AW_TABLE_SLACK = 16


def launch_accept_wavefront_indexed(reads, table, offsets, params, out,
                                    W: int) -> None:
    """K1's indexed entry (csrc/accept_wavefront.cu) into out, int32 [N]
    zeros, as launch_accept_wavefront but each row's bytes read by offset:
    reads uint8 [R, L] (a read table: a row's read_len bytes from its read
    offset), table uint8 [T] (a window table, AW_TABLE_SLACK bytes past its
    last window), offsets int64 [N, 2] = (read offset into reads, window
    offset into table), params int32 [N, 5] with 0 <= read_len <= L,
    win_len <= W, and each row's spans inside its tables (the caller
    checks them on the host)."""
    import torch

    _require(reads, "reads", torch.uint8, 2)
    _require(table, "table", torch.uint8, 1)
    _require(offsets, "offsets", torch.int64, 2)
    _require(params, "params", torch.int32, 2)
    _require(out, "out", torch.int32, 1)
    n = offsets.shape[0]
    if (offsets.shape[1] != 2 or tuple(params.shape) != (n, 5)
            or out.shape[0] != n):
        raise ValueError("offsets must be int64 [N, 2], params int32 [N, 5] "
                         "and out int32 [N]")
    _launch("accept_wavefront_indexed", reads.data_ptr(), table.data_ptr(),
            offsets.data_ptr(), params.data_ptr(), out.data_ptr(), n,
            reads.shape[1], W, reads.numel(), table.numel())


def accept_wavefront_indexed(reads, table, offsets, params, W: int):
    """K1's indexed entry: bool [N] per row (see
    launch_accept_wavefront_indexed)."""
    import torch

    out = torch.zeros(offsets.shape[0], dtype=torch.int32,
                      device=offsets.device)
    launch_accept_wavefront_indexed(reads, table, offsets, params, out, W)
    return out != 0


# K5's default slice length (csrc/kmer_bitmap_screen.cuh KB_SLICE) and its
# bitmap words a window
KB_SLICE = 16384
KB_WORDS = 2048


def kb_passes(reads, table, offsets, lengths, row_read, tasks, out,
              schedule) -> list:
    """K5's two launches (csrc/kmer_bitmap_screen.cu) after the checks of
    launch_kmer_bitmap_screen: [(C entry point, arguments)], the build
    pass's and the test pass's, with the scratch bitmap, int32 [windows
    used, KB_WORDS], allocated as zeros; none for N = 0 or K = 0."""
    import torch

    _require(reads, "reads", torch.uint8, 2)
    _require(table, "table", torch.uint8, 1)
    _require(offsets, "offsets", torch.int64, 1)
    _require(lengths, "lengths", torch.int32, 1)
    _require(row_read, "row_read", torch.int32, 1)
    _require(tasks, "tasks", torch.int32, 2)
    _require(out, "out", torch.uint8, 1)
    n = row_read.shape[0]
    L = reads.shape[1]
    if (lengths.shape[0] != offsets.shape[0] or tasks.shape[1] != 3
            or out.shape[0] != n):
        raise ValueError("lengths must match offsets, tasks be int32 "
                         "[K, 3] and out uint8 [N]")
    if L % 16 or reads.data_ptr() % 16 or table.data_ptr() % 16:
        raise ValueError("K5 loads 16 bytes at a time: reads must be a "
                         "multiple of 16 bytes wide and both tables start on "
                         "a 16-byte boundary")
    if n == 0 or tasks.shape[0] == 0:
        return []
    _require(schedule.rank_window, "rank_window", torch.int32, 1)
    _require(schedule.task_rank, "task_rank", torch.int32, 1)
    _require(schedule.slices, "slices", torch.int32, 2)
    used = schedule.rank_window.shape[0]
    n_slices = schedule.slices.shape[0]
    if (schedule.task_rank.shape[0] != tasks.shape[0]
            or schedule.slices.shape[1] != 2 or schedule.slice_len <= 0
            or schedule.slice_len % 16):
        raise ValueError("the schedule must rank every task and cut slices "
                         "of a positive multiple of 16 positions")
    bitmaps = torch.zeros((max(used, 1), KB_WORDS), dtype=torch.int32,
                          device=tasks.device)
    return [("kmer_bitmap_build",
             (table, offsets, lengths, schedule.rank_window, schedule.slices,
              bitmaps, n_slices, used, offsets.shape[0], table.numel(),
              schedule.slice_len)),
            ("kmer_bitmap_test",
             (reads, row_read, tasks, schedule.task_rank, bitmaps, out, n,
              tasks.shape[0], L, reads.shape[0], used))]


def launch_kmer_bitmap_screen(reads, table, offsets, lengths, row_read,
                              tasks, out, schedule) -> None:
    """K5 (csrc/kmer_bitmap_screen.cu) into out, uint8 [N]: 1 where an
    8-mer of the row's read, in either orientation, occurs in its window,
    else 0. reads uint8 [2 R, L] holds raw rows (2 r forward, 2 r + 1
    reverse complement; 0 past the read; L a multiple of 16), table uint8
    [T] raw window bytes, offsets int64 [W] and lengths int32 [W] each
    window's span of it, row_read int32 [N] each row's read id, the rows
    sorted by window, and tasks int32 [K, 3] = (window, first row, end row)
    the rows a block tests against one window's bitmap
    (ops/realign.screen_tasks); schedule, realign.screen_schedule's for
    these tasks, the slices of the windows that the build pass sets. Two
    launches (kb_passes), each checked, counted once; none for N = 0 or K
    = 0."""
    passes = kb_passes(reads, table, offsets, lengths, row_read, tasks, out,
                       schedule)
    for name, args in passes:
        _call(name, *args)
    if passes:
        launch_counts["kmer_bitmap_screen"] += 1


def kmer_bitmap_screen(reads, table, offsets, lengths, row_read, tasks,
                       schedule):
    """K5: bool [N] shared-8-mer verdicts in the rows' order (see
    launch_kmer_bitmap_screen); a row no task names stays False."""
    import torch

    out = torch.zeros(row_read.shape[0], dtype=torch.uint8,
                      device=row_read.device)
    launch_kmer_bitmap_screen(reads, table, offsets, lengths, row_read,
                              tasks, out, schedule)
    return out.view(torch.bool)


# K1's "no active walk" score (csrc/accept_wavefront.cuh AW_NEG)
AW_NEG = -(1 << 20)


def accept_walks_all(params, L: int):
    """bool [N]: the rows of K1's params (int32 [N, 5]) for reads L bytes
    wide that walk every diagonal, as the kernel decides per row
    (aw_walks_all): min_score <= read_len - 2^20, read_len clamped to [0,
    L], within an unseeded walk's reach. The other rows take the seed
    lookup."""
    read_len = params[:, 0].long().clamp(0, L)
    return params[:, 2].long() <= read_len + AW_NEG


def accept_wavefront(reads, windows, params):
    """K1: bool [N] per (read, window) row (see launch_accept_wavefront)."""
    import torch

    out = torch.zeros(reads.shape[0], dtype=torch.int32, device=reads.device)
    launch_accept_wavefront(reads, windows, params, out)
    return out != 0


# K2 takes positions as int32; rows of at most LE_PACKED_MAX_CODES codes
# (csrc/low_entropy.cuh, whose packed entry point refuses wider rows) take
# its packed counters, wider ones its long-row kernel
LE_MAX_CODES = (1 << 31) - 1
LE_PACKED_MAX_CODES = 3072
# the long-row kernel's lanes a read (LE_LONG_LANES in csrc/low_entropy.cuh)
LE_LONG_LANES = 32


def le_route(row_bytes: int) -> str:
    """The K2 entry point for packed rows of row_bytes bytes: "low_entropy"
    (arriba_low_entropy, the packed counters) up to LE_PACKED_MAX_CODES
    codes, "low_entropy_long" (arriba_low_entropy_long, a group of
    LE_LONG_LANES lanes a read) past them. Launches nothing."""
    return ("low_entropy" if 4 * row_bytes <= LE_PACKED_MAX_CODES
            else "low_entropy_long")


def launch_low_entropy(packed, meta, out) -> None:
    """K2 (csrc/low_entropy.cu) into out, uint8 [N]: 1 for a low-entropy
    read, else 0. packed uint8 [N, B] holds 4 two-bit codes per byte (low
    bits first); meta int32 [N, 8] = (length, a1s, a1e, a2s, a2e, th_all,
    th_a1, th_a2) with length <= 4 * B. The row width picks the kernel
    before launch (le_route): rows of at most 3,072 codes select one 3-mer
    at most 1,023 times and keep its three counters in 10-bit fields of one
    word, a thread a read; wider rows take a group of lanes a read, each
    lane a chunk of the read in the same packed words, flushed into 32-bit
    totals before a field could pass 1,023, counted as
    "low_entropy_long"."""
    import torch

    _require(packed, "packed", torch.uint8, 2)
    _require(meta, "meta", torch.int32, 2)
    _require(out, "out", torch.uint8, 1)
    n, row_bytes = packed.shape
    if tuple(meta.shape) != (n, 8) or out.shape[0] != n:
        raise ValueError("meta must be int32 [N, 8] and out uint8 [N]")
    if 4 * row_bytes > LE_MAX_CODES:
        raise ValueError(f"rows longer than {LE_MAX_CODES:,} codes overflow "
                         f"K2's int32 positions")
    _launch(le_route(row_bytes), packed.data_ptr(), meta.data_ptr(),
            out.data_ptr(), n, row_bytes)


def low_entropy(packed, meta):
    """K2: bool [N] low-entropy flags (see launch_low_entropy)."""
    import torch

    out = torch.empty(packed.shape[0], dtype=torch.uint8,
                      device=packed.device)
    launch_low_entropy(packed, meta, out)
    return out.view(torch.bool)


# K3 runs two rows in the 16-bit halves of each word and shuffles 13 bits
# of h a row (csrc/smith_waterman.cuh gives the proof)
SW_MAX_L = 512
SW_MAX_SCORE = (1 << 13) - 1


def sw_score_refusal(L: int, W: int, match: int, mismatch: int,
                     gap: int) -> str:
    """'' when 16-bit pair lanes carry these scores exactly at reads L
    wide against windows W wide (every h below 2^13, match - gap and
    mismatch - gap in a signed byte, |gap| <= 2^14), else the reason they
    do not. From shapes and parameters alone."""
    if max(match, mismatch, 0) * L + max(gap, 0) * (L + W) > SW_MAX_SCORE:
        return "scores could reach 2^13, which K3's 16-bit lanes do not carry"
    if not (-128 <= match - gap <= 127 and -128 <= mismatch - gap <= 127
            and abs(gap) <= 1 << 14):
        return ("match - gap and mismatch - gap must lie in [-128, 127] and "
                "|gap| <= 2^14 for K3")
    return ""


def sw_refusal(L: int, W: int, match: int, mismatch: int, gap: int) -> str:
    """'' when K3 carries these shapes and scores exactly (L <= 512 and
    sw_score_refusal finds nothing), else the reason it does not. From
    shapes and parameters alone."""
    if L > SW_MAX_L:
        return (f"smith_waterman takes reads of at most {SW_MAX_L} "
                f"positions, got {L}")
    return sw_score_refusal(L, W, match, mismatch, gap)


def sw_guard(L: int, W: int, match: int, mismatch: int, gap: int) -> None:
    """Raise ValueError unless K3 carries these shapes and scores exactly
    (sw_refusal). Decided before launch, from shapes and parameters
    alone."""
    reason = sw_refusal(L, W, match, mismatch, gap)
    if reason:
        raise ValueError(reason)


# PAD_CODE of ops/encode.py, K3's largest code
SW_PAD = 4


def sw_codes_guard(reads, windows) -> None:
    """Raise ValueError unless every byte of reads and windows is a code
    0-4. K3 ships window codes in 3 bits and reads bit 2 as PAD, so a
    larger byte would score wrongly where the plain version compares whole
    bytes. One reduction over each input; on CUDA tensors it waits for the
    card."""
    for name, x in (("reads", reads), ("windows", windows)):
        if x.numel() and int(x.amax()) > SW_PAD:
            raise ValueError(f"smith_waterman takes codes 0-{SW_PAD} "
                             f"(PAD {SW_PAD}); {name} holds "
                             f"{int(x.amax())}")


# K3w's int32 lanes (csrc/smith_waterman_wide.cuh gives the proof)
SW_WIDE_MAX = (1 << 31) - 1


def sw_wide_guard(L: int, W: int, match: int, mismatch: int,
                  gap: int) -> None:
    """Raise ValueError unless every h and every sum of K3w stays inside
    int32, where the JAX op's own int32 arithmetic is exact too:
    max(match, mismatch, 0) * L + max(gap, 0) * (L + W) plus the largest
    of match, mismatch, gap and 0 below 2^31, each parameter an int32."""
    for name, value in (("match", match), ("mismatch", mismatch),
                        ("gap", gap)):
        if not -(1 << 31) <= value <= SW_WIDE_MAX:
            raise ValueError(f"{name} = {value} is not an int32")
    top = max(match, mismatch, 0)
    bound = top * L + max(gap, 0) * (L + W) + max(top, gap)
    if bound > SW_WIDE_MAX:
        raise ValueError(f"scores could reach {bound}, past int32 (the JAX "
                         f"op's int32 sums would wrap too)")


def sw_route(reads, windows, match: int = 1, mismatch: int = -1,
             gap: int = -1) -> str:
    """The kernel smith_waterman launches for these inputs, where
    sw_score_refusal finds nothing and every byte is a code 0-4:
    "smith_waterman" (K3) for L <= 512, "smith_waterman_wide16" (K3w's
    16-bit pairs) past it; for any other input "smith_waterman_wide" (K3w's
    32-bit lanes). Launches nothing; the bytes are read (one reduction,
    which waits for the card) only when the scores fit 16 bits."""
    L, W = reads.shape[1], windows.shape[1]
    if sw_score_refusal(L, W, match, mismatch, gap):
        return "smith_waterman_wide"
    try:
        sw_codes_guard(reads, windows)
    except ValueError:
        return "smith_waterman_wide"
    return "smith_waterman" if L <= SW_MAX_L else "smith_waterman_wide16"


def launch_smith_waterman(reads, windows, out, match: int = 1,
                          mismatch: int = -1, gap: int = -1) -> None:
    """K3 (csrc/smith_waterman.cu) into out, int32 [N]: the best local
    alignment score of each (read, window) row. reads uint8 [N, L] and
    windows uint8 [N, W] must hold codes 0-4, both padded with PAD_CODE
    (4): this launch does not read the bytes, smith_waterman checks them
    (sw_route). The shapes and scores pass sw_guard."""
    import torch

    _require(reads, "reads", torch.uint8, 2)
    _require(windows, "windows", torch.uint8, 2)
    _require(out, "out", torch.int32, 1)
    n, L = reads.shape
    W = windows.shape[1]
    if windows.shape[0] != n or out.shape[0] != n:
        raise ValueError("reads, windows and out must have the same rows")
    sw_guard(L, W, match, mismatch, gap)
    _launch("smith_waterman", reads.data_ptr(), windows.data_ptr(),
            out.data_ptr(), n, L, W, match, mismatch, gap)


def _carry_rows(n: int, route: str) -> int:
    return (n + 1) // 2 if route == "smith_waterman_wide16" else n


def sw_wide_carry(reads, windows, route: str = "smith_waterman_wide"):
    """K3w's carry rows where a read can span more than one tile (L > 512):
    int32 [N, W] for the 32-bit lanes, [ceil(N / 2), W] for the 16-bit
    pairs (route "smith_waterman_wide16"); an empty tensor otherwise."""
    import torch

    n, L = reads.shape
    W = windows.shape[1] if L > SW_MAX_L else 0
    return torch.empty((_carry_rows(n, route), W), dtype=torch.int32,
                       device=reads.device)


def _launch_wide(route: str, reads, windows, out, carry, match: int,
                 mismatch: int, gap: int) -> None:
    """Check K3w's arguments and its guard for the width route names
    (sw_score_refusal for the 16-bit pairs, sw_wide_guard for the 32-bit
    lanes), then launch it."""
    import torch

    _require(reads, "reads", torch.uint8, 2)
    _require(windows, "windows", torch.uint8, 2)
    _require(out, "out", torch.int32, 1)
    _require(carry, "carry", torch.int32, 2)
    n, L = reads.shape
    W = windows.shape[1]
    if windows.shape[0] != n or out.shape[0] != n:
        raise ValueError("reads, windows and out must have the same rows")
    rows = _carry_rows(n, route)
    if L > SW_MAX_L and tuple(carry.shape) != (rows, W):
        raise ValueError(f"carry must be int32 [{rows}, {W}] for reads past "
                         f"{SW_MAX_L} positions")
    if route == "smith_waterman_wide16":
        reason = sw_score_refusal(L, W, match, mismatch, gap)
        if reason:
            raise ValueError(reason)
    else:
        sw_wide_guard(L, W, match, mismatch, gap)
    _launch(route, reads.data_ptr(), windows.data_ptr(), out.data_ptr(),
            carry.data_ptr(), n, L, W, match, mismatch, gap)


def launch_smith_waterman_wide16(reads, windows, out, carry,
                                 match: int = 1, mismatch: int = -1,
                                 gap: int = -1) -> None:
    """K3w's 16-bit pairs (csrc/smith_waterman_wide.cu) into out, int32
    [N]: the best local alignment score of each (read, window) row, two
    rows a warp as K3 scores them, tiled over reads of any L. reads uint8
    [N, L] and windows uint8 [N, W] must hold codes 0-4, both padded with
    PAD_CODE (4): this launch does not read the bytes, smith_waterman
    checks them (sw_route). carry is sw_wide_carry's scratch for this
    route. The scores pass sw_score_refusal."""
    _launch_wide("smith_waterman_wide16", reads, windows, out, carry, match,
                 mismatch, gap)


def launch_smith_waterman_wide(reads, windows, out, carry, match: int = 1,
                               mismatch: int = -1, gap: int = -1) -> None:
    """K3w's 32-bit lanes (csrc/smith_waterman_wide.cu) into out, int32
    [N]: the best local alignment score of each (read, window) row, a row a
    warp, for any L and W and any bytes (PAD 4). carry is sw_wide_carry's
    scratch. The shapes and scores pass sw_wide_guard."""
    _launch_wide("smith_waterman_wide", reads, windows, out, carry, match,
                 mismatch, gap)


def smith_waterman(reads, windows, match: int = 1, mismatch: int = -1,
                   gap: int = -1):
    """K3 or one of K3w's widths, as sw_route decides before launch: int32
    [N] scores (see launch_smith_waterman, launch_smith_waterman_wide16,
    launch_smith_waterman_wide). Raises ValueError, before launch, only
    past sw_wide_guard."""
    import torch

    route = sw_route(reads, windows, match, mismatch, gap)
    out = torch.empty(reads.shape[0], dtype=torch.int32, device=reads.device)
    if route == "smith_waterman":
        launch_smith_waterman(reads, windows, out, match, mismatch, gap)
        return out
    _launch_wide(route, reads, windows, out,
                 sw_wide_carry(reads, windows, route), match, mismatch, gap)
    return out


def mxu_route(k: int) -> str:
    """The kernel mxu_kmer_screen launches for k-mers of length k:
    "mxu_kmer_screen" (K4) for k = 8, "mxu_kmer_screen_any_k" (csrc/
    mxu_kmer_screen.cuh, "K4 at any k") for any other k >= 1; ValueError
    for k < 1, where the JAX op fails too (it stacks no positions)."""
    if k < 1:
        raise ValueError(f"k-mers of length {k}: K4 takes 1 <= k")
    return "mxu_kmer_screen" if k == 8 else "mxu_kmer_screen_any_k"


def mxu_any_chunk(k: int) -> int:
    """The window k-mers a stage of the any-k kernel holds at k >= 1
    (mk_any_layout in csrc/mxu_kmer_screen.cuh, asked of the built
    library), so that a caller can place a k-mer across a stage's chunk.
    Launches nothing."""
    import ctypes

    from .build import host_function

    return host_function("mxu_kmer_screen",
                         "arriba_mxu_kmer_screen_any_k_chunk",
                         [ctypes.c_int], ctypes.c_int)(k)


def launch_mxu_kmer_screen(reads, windows, out, k: int = 8) -> None:
    """K4 (csrc/mxu_kmer_screen.cu) into out, uint8 [N]: 1 where some
    k-mer of the read occurs in the window, else 0. reads uint8 [N, L] and
    windows uint8 [N, W] hold codes; a byte above 3 (PAD 4 or larger) one-
    hots to zero, so no k-mer that covers one matches. k = 8 launches K4,
    any other k its any-k kernel (mxu_route). No launch for N = 0 (nothing
    to write)."""
    import torch

    route = mxu_route(k)
    _require(reads, "reads", torch.uint8, 2)
    _require(windows, "windows", torch.uint8, 2)
    _require(out, "out", torch.uint8, 1)
    n, L = reads.shape
    W = windows.shape[1]
    if windows.shape[0] != n or out.shape[0] != n:
        raise ValueError("reads, windows and out must have the same rows")
    if n == 0:
        return
    if route == "mxu_kmer_screen":
        _launch(route, reads.data_ptr(), windows.data_ptr(), out.data_ptr(),
                n, L, W)
    else:
        # a k past L leaves the read no k-mer, as L + 1 does (an int32)
        _launch(route, reads.data_ptr(), windows.data_ptr(), out.data_ptr(),
                n, L, W, min(k, L + 1))


def mxu_kmer_screen(reads, windows, k: int = 8):
    """K4: bool [N] shared-k-mer verdicts (see launch_mxu_kmer_screen)."""
    import torch

    out = torch.empty(reads.shape[0], dtype=torch.uint8, device=reads.device)
    launch_mxu_kmer_screen(reads, windows, out, k)
    return out.view(torch.bool)


# K6 (csrc/bam_ingest.cu), the card pass over a BGZF BAM (ingest/card.py
# drives it chunk by chunk and holds the buffers; the launches below check
# what they can without waiting for the card). CTX_BYTES holds a BiKey
# (csrc/bam_ingest.cuh: 40 bytes of fields and a 256-byte name).
CTX_BYTES = 512


def launch_bgzf_inflate(comp, member_offset, member_size, out_offset, out,
                        status, stats) -> None:
    """Inflate each BGZF member of comp (uint8) at member_offset (int64
    [M], its size member_size, int64 [M]) into out (uint8) at out_offset
    (int64 [M]), a warp a member; status int32 [>= M] gets each member's
    bam_ingest.cuh error code (0 where it checks), stats[3] (int64 [16])
    the count that failed."""
    import torch

    _require(comp, "comp", torch.uint8, 1)
    _require(out, "out", torch.uint8, 1)
    _require(status, "status", torch.int32, 1)
    _require(stats, "stats", torch.int64, 1)
    for name, x in (("member_offset", member_offset),
                    ("member_size", member_size), ("out_offset", out_offset)):
        _require(x, name, torch.int64, 1)
    m = member_offset.shape[0]
    if member_size.shape[0] != m or out_offset.shape[0] != m \
            or status.shape[0] < m:
        raise ValueError("one offset, size, out offset and status a member")
    _launch("bgzf_inflate", comp, member_offset, member_size, out_offset, m,
            out, status, stats)


def launch_bam_frame(buf, end: int, seg_lo, seg_hi, n_ref: int, seg, walked,
                     starts, stats) -> None:
    """Frame the records of buf[:end] from its ranges [seg_lo, seg_hi)
    (int64 [S]; the first range's start is a record start): starts (int64)
    gets every record start whole inside end, stats[0] their count,
    stats[1] where the chain stops and stats[2] how (0 at end, 1 at a
    partial record, 2 at a block_size <= 0). seg (int64 [>= 4 S]) and
    walked (int32 [>= S]) are scratch."""
    import torch

    _require(buf, "buf", torch.uint8, 1)
    for name, x in (("seg_lo", seg_lo), ("seg_hi", seg_hi), ("seg", seg),
                    ("starts", starts), ("stats", stats)):
        _require(x, name, torch.int64, 1)
    _require(walked, "walked", torch.int32, 1)
    s = seg_lo.shape[0]
    if seg_hi.shape[0] != s or seg.shape[0] < 4 * s or walked.shape[0] < s \
            or not 0 <= end <= buf.shape[0] or starts.shape[0] < end // 36 + 1:
        raise ValueError("ranges, scratch and starts do not fit buf")
    _launch("bam_frame", buf, end, seg_lo, seg_hi, s, n_ref, seg[:s],
            seg[s:2 * s], seg[2 * s:3 * s], walked, seg[3 * s:4 * s], starts,
            stats)


def launch_bam_pairs(buf, starts, stats, final: bool, ctx_in, ctx_out,
                     contigs, test, maybe, same, cov, cov_starts, cov_ends,
                     kept_size, kept, chain_start) -> None:
    """Test and take the adjacent pairs of the stats[0] records at starts
    (launch_bam_frame), add the taken pairs' coverage into cov (int32) and
    their flags into cov_starts / cov_ends (uint8) over the flat planes,
    count them in stats[4] (records) and stats[5] (on interesting
    contigs), and give each record slot its kept size (int64, 0 where
    taken or past the records), kept flag (int32) and chain_start (uint8:
    it may begin a chain the engine pairs by its decode tiles; stats[7]
    counts them). ctx_in / ctx_out (uint8 [CTX_BYTES], bam_ingest.cuh
    BiKey) carry the last record's key from one chunk to the next; final:
    no chunk follows. test, maybe and same are scratch. contigs: (bounds,
    bound_offset, plane_offset, interesting, viral, n_tids, external
    duplicate marking) as ingest.card.Contigs holds them."""
    import torch

    (bounds, bound_offset, plane_offset, interesting, viral, n_tids,
     external) = contigs
    _require(buf, "buf", torch.uint8, 1)
    cap = starts.shape[0]
    for name, x, dtype in (("starts", starts, torch.int64),
                           ("test", test, torch.uint8),
                           ("maybe", maybe, torch.uint8),
                           ("same", same, torch.uint8),
                           ("kept_size", kept_size, torch.int64),
                           ("kept", kept, torch.int32),
                           ("chain_start", chain_start, torch.uint8)):
        _require(x, name, dtype, 1)
        if x.shape[0] != cap:
            raise ValueError(f"{name} must have one slot a record")
    _require(cov, "cov", torch.int32, 1)
    _require(cov_starts, "cov_starts", torch.uint8, 1)
    _require(cov_ends, "cov_ends", torch.uint8, 1)
    if ctx_in.shape[0] < CTX_BYTES or ctx_out.shape[0] < CTX_BYTES \
            or bound_offset.shape[0] != n_tids + 1 \
            or plane_offset.shape[0] != n_tids + 1:
        raise ValueError("contexts of CTX_BYTES and one offset a tid")
    _launch("bam_pairs", buf, starts, stats, cap, 1 if final else 0, ctx_in,
            ctx_out, bounds, bound_offset, plane_offset, interesting, viral,
            n_tids, external, test, maybe, same, cov, cov_starts, cov_ends,
            kept_size, kept, chain_start)


def launch_bam_residue(buf, starts, stats, base: int, kept_size, size_sum,
                       kept_sum, chain_start, res, res_offset, res_record,
                       res_chain) -> None:
    """Copy the kept records (launch_bam_pairs) in order into res at the
    inclusive sums size_sum (int64) and kept_sum (int32) of their sizes and
    flags; residue slot j gets its byte offset, its record index (base +
    its index in the chunk) and its chain_start flag."""
    import torch

    cap = starts.shape[0]
    for name, x in (("kept_size", kept_size), ("size_sum", size_sum),
                    ("res_offset", res_offset), ("res_record", res_record)):
        _require(x, name, torch.int64, 1)
        if x.shape[0] != cap:
            raise ValueError(f"{name} must have one slot a record")
    _require(kept_sum, "kept_sum", torch.int32, 1)
    _require(res, "res", torch.uint8, 1)
    _require(res_chain, "res_chain", torch.uint8, 1)
    _launch("bam_residue", buf, starts, stats, cap, base, kept_size, size_sum,
            kept_sum, chain_start, res, res_offset, res_record, res_chain)


def launch_bam_coverage_finish(cov, out) -> None:
    """out (int16 holding uint16 bits) = cov (int32) saturated at 0xFFFF."""
    import torch

    _require(cov, "cov", torch.int32, 1)
    _require(out, "out", torch.int16, 1)
    if out.shape[0] != cov.shape[0]:
        raise ValueError("out must match cov")
    _launch("bam_coverage_finish", cov, out, cov.shape[0])
