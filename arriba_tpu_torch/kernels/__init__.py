"""Hand-written CUDA kernels (sm_90a) and their PyTorch-facing wrappers.

Each ``launch_*`` function takes CUDA tensors only, checks device, type,
shape and contiguity (tensor metadata, so it never waits for the card),
launches on PyTorch's current stream into an output the caller allocated,
and raises if the launch returned a CUDA error. It adds one to
``launch_counts[name]`` where it launches, and nowhere else, so a run can
show that its main path went through the kernel. The value ranges of the
row lengths and of K1's min_score are checked on the host where the
callers build them; the kernels clamp those lengths to their rows, so no
value can make them read outside their inputs. What a kernel cannot carry
exactly is refused before launch: K3's scores past 16 bits by shape and
parameters (``sw_guard``), and K3's bytes above code 4 by
``smith_waterman``, which reads the inputs' largest byte from the card
(``sw_codes_guard``) before it launches. ``accept_wavefront``,
``low_entropy`` and ``smith_waterman`` allocate the output and return
bool verdicts (int32 scores for the last). The plain PyTorch versions (the CPU path and the
reference the kernels are held against) live beside their callers in
``ops/``.
"""

from __future__ import annotations

launch_counts = {"accept_wavefront": 0, "low_entropy": 0,
                 "smith_waterman": 0}


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


def _launch(name: str, *args) -> None:
    import torch

    from .build import load

    launch, error_string = load(name)
    code = launch(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"{error_string(code)} ({code})")
    launch_counts[name] += 1


def launch_accept_wavefront(reads, windows, params, out) -> None:
    """K1 (csrc/accept_wavefront.cu) into out, int32 [N] zeros: a row's
    entry becomes non-zero when it accepts. reads uint8 [N, L] (pad byte
    0), windows uint8 [N, W] (pad byte 1), params int32 [N, 5] =
    (read_len, win_len, min_score, seed_lo, seed_hi) with
    0 <= read_len <= L, win_len <= W and min_score > read_len - 2^20. K1
    walks only the diagonals a seed names; without a fired seed a walk
    scores at most read_len - 2^20, so that min_score is out of its
    reach."""
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
    if n > 65535:
        raise ValueError("accept_wavefront takes at most 65535 rows a launch")
    _launch("accept_wavefront", reads.data_ptr(), windows.data_ptr(),
            params.data_ptr(), out.data_ptr(), n, L, W)


def accept_wavefront(reads, windows, params):
    """K1: bool [N] per (read, window) row (see launch_accept_wavefront)."""
    import torch

    out = torch.zeros(reads.shape[0], dtype=torch.int32, device=reads.device)
    launch_accept_wavefront(reads, windows, params, out)
    return out != 0


# K2 takes positions as int32
LE_MAX_CODES = (1 << 31) - 1


def launch_low_entropy(packed, meta, out) -> None:
    """K2 (csrc/low_entropy.cu) into out, uint8 [N]: 1 for a low-entropy
    read, else 0. packed uint8 [N, B] holds 4 two-bit codes per byte (low
    bits first); meta int32 [N, 8] = (length, a1s, a1e, a2s, a2e, th_all,
    th_a1, th_a2) with length <= 4 * B. The row width picks the counters
    before launch (arriba_low_entropy): rows of at most 3,072 codes select
    one 3-mer at most 1,023 times and keep its three counters in 10-bit
    fields of one word; wider rows keep three 32-bit counters."""
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
    _launch("low_entropy", packed.data_ptr(), meta.data_ptr(), out.data_ptr(),
            n, row_bytes)


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


def sw_guard(L: int, W: int, match: int, mismatch: int, gap: int) -> None:
    """Raise ValueError unless K3 carries these shapes and scores exactly:
    L <= 512, every h below 2^13, match - gap and mismatch - gap in a
    signed byte, |gap| <= 2^14. Decided before launch, from shapes and
    parameters alone."""
    if L > SW_MAX_L:
        raise ValueError(f"smith_waterman takes reads of at most {SW_MAX_L} "
                         f"positions, got {L}")
    if max(match, mismatch, 0) * L + max(gap, 0) * (L + W) > SW_MAX_SCORE:
        raise ValueError("scores could reach 2^13, which K3's 16-bit lanes "
                         "do not carry")
    if not (-128 <= match - gap <= 127 and -128 <= mismatch - gap <= 127
            and abs(gap) <= 1 << 14):
        raise ValueError("match - gap and mismatch - gap must lie in "
                         "[-128, 127] and |gap| <= 2^14 for K3")


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


def launch_smith_waterman(reads, windows, out, match: int = 1,
                          mismatch: int = -1, gap: int = -1) -> None:
    """K3 (csrc/smith_waterman.cu) into out, int32 [N]: the best local
    alignment score of each (read, window) row. reads uint8 [N, L] and
    windows uint8 [N, W] must hold codes 0-4, both padded with PAD_CODE
    (4): this launch does not read the bytes, smith_waterman checks them
    (sw_codes_guard). The shapes and scores pass sw_guard."""
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


def smith_waterman(reads, windows, match: int = 1, mismatch: int = -1,
                   gap: int = -1):
    """K3: int32 [N] scores (see launch_smith_waterman). Raises
    ValueError, before launch, for a byte above code 4 (sw_codes_guard)."""
    import torch

    sw_codes_guard(reads, windows)
    out = torch.empty(reads.shape[0], dtype=torch.int32, device=reads.device)
    launch_smith_waterman(reads, windows, out, match, mismatch, gap)
    return out
