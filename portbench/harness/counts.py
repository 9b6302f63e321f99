"""
The yardstick's arithmetic: the H100's peaks, the least time of a piece
of work, and the work of the engine's scan counted from a cell's shapes.
It imports nothing of the program.

HBM_BYTES_PER_S, F32_FLOPS, bound and rfft_flops are copies of
chip_smoke.py's.
"""
from __future__ import annotations

import math

# H100 SXM peaks (NVIDIA's data sheet): device memory and float32 outside
# the tensor cores, the rate every kernel of the scan computes at
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BINS = 400
# the engine's overlap-save block for a template of n_c samples a channel:
# 2^bit_length(4 n_c), at least 16384 when the chunk's full-length FFT is
# that long (copy of the rule of detex_torch/ops/ds.build_bank)
FUSED_BLOCK = 16384


def bound(nbytes, flops):
    """(seconds, "bytes" or "operations"): the least time the card could
    take to move ``nbytes`` through device memory and do ``flops`` float32
    operations, the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rfft_flops(n):
    """Operations of one real FFT of n points (2.5 n log2 n)."""
    return 2.5 * n * math.log2(n)


def pad_rows(S):
    """Rows a bank of S detectors holds (the engine pads to a ladder; copy
    of ops/ds.pad_rows): the smallest S' >= S that is a multiple of
    max(8, 2^(bit_length(S - 1) - 3))."""
    if S <= 8:
        return 8
    q = max(8, 1 << (int(S - 1).bit_length() - 3))
    return -(-S // q) * q


def os_block(n_c, L_c):
    blk = 2 ** int(4 * n_c).bit_length()
    nfft2 = 2 ** int(L_c + n_c).bit_length()
    if blk < FUSED_BLOCK and nfft2 >= FUSED_BLOCK:
        blk = FUSED_BLOCK
    return min(blk, nfft2)


def scan_work(n_chunks, batch, S, D, nc, n_c, L_c, device_filter):
    """(bytes, flops) of scanning ``n_chunks`` chunks of L_c samples a
    channel with S detectors of D basis rows and n_c samples a channel, in
    batches of ``batch``: each raw float32 input byte read once, the
    bank's spectra read once a batch, the summaries (maxima, histograms)
    written once; the operations of the device filter (one real FFT and
    one inverse a channel at the padded length, and the response
    multiply) and of the overlap-save correlation at the engine's block
    (one real FFT a channel and frame, the channel multiply-accumulate a
    basis row, one inverse FFT a basis row and frame)."""
    Sp = pad_rows(S)
    Dp = 1 << max(int(D - 1).bit_length(), 0)
    blk = os_block(n_c, L_c)
    W = blk - n_c + 1
    frames = -(-(L_c - n_c + 1) // W)
    bins = blk // 2 + 1
    batches = -(-n_chunks // batch)
    nbytes = (n_chunks * nc * L_c * 4 +
              batches * Sp * Dp * nc * bins * 8 +
              batches * batch * Sp * 4 + batches * Sp * BINS * 4)
    per_chunk = (nc * frames * rfft_flops(blk) +
                 Sp * Dp * frames * nc * bins * 8 +
                 Sp * Dp * frames * rfft_flops(blk))
    if device_filter:
        nf = 2 ** int(L_c + n_c).bit_length()
        per_chunk += nc * (2 * rfft_flops(nf) + 6 * (nf // 2 + 1))
    return nbytes, n_chunks * per_chunk
