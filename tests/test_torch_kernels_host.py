"""The CUDA kernel sources of detex_torch, compiled for the host with g++
against detex_torch/kernels/emulation (one thread block runs as std::threads
with real barriers and warp exchanges), held against the kernels' PyTorch
twins at small geometries (blk 16384 and 32768; the full-length finalize
at a few row lengths). This checks the kernels'
arithmetic, indexing, shared-memory reuse and synchronisation on a machine
without a GPU; speed, the memory model and nvcc's acceptance of the code
are only checked on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances as on the card: spectra atol 2e-3, a atol 1e-4, power rtol 1e-4
/ atol 1e-3, pad values exact, ds and block maxima atol 2e-5 with -inf
positions identical, histogram totals exact, inverse transforms within 2e-5
of the twin relative to the row's largest value.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from detex_torch.ops import dft
from detex_torch.ops import ds as tds
from detex_torch.ops import reference as ref

KDIR = Path(tds.__file__).resolve().parents[1] / "kernels"
NC = 3
# (blk, n_c, L_c): two overlap-save blocks per chunk; 129 is the pad0 == 0
# branch, 16300 the widest template the fused route takes at blk 32768
GEOMS = {"560": (16384, 560, 20000), "129": (16384, 129, 20000),
         "16300": (32768, 16300, 40000)}


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++)")
    so = tmp_path_factory.mktemp("emu") / "libemu.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-shared", "-fPIC",
                    "-I", str(KDIR / "emulation"), "-I", str(KDIR), "-o",
                    str(so), str(KDIR / "emulation" / "emulate.cpp"),
                    "-lpthread"], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.emu_fwd_prep_fold.argtypes = [P] * 7 + [I, I, LL, I, I, I, I, I, LL,
                                                I, I]
    lib.emu_spec_ds_fold.argtypes = [P] * 13 + [I] * 11
    lib.emu_rfft_ct.argtypes = [P] * 4 + [LL, LL, I, I, I]
    lib.emu_fft_regs.argtypes = [P] * 3 + [LL, I]
    lib.emu_ifft_regs.argtypes = [P] * 4 + [LL, I]
    lib.emu_irfft_ct.argtypes = [P] * 4 + [LL, I]
    lib.emu_ds_finalize_os_fold.argtypes = [P] * 8 + [LL] + [I] * 7
    lib.emu_ds_finalize_os_scan.argtypes = [P] * 8 + [LL] + [I] * 6
    lib.emu_ds_finalize_os.argtypes = [P] * 5 + [LL] + [I] * 5
    lib.emu_hist_uniform.argtypes = [P] * 2 + [LL, LL, I]
    lib.emu_rfft_ct_half.argtypes = [P] * 5 + [LL, LL, I, I, I, I]
    lib.emu_ds_finalize.argtypes = [P] * 5 + [LL, I, LL]
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _prep_inputs(blk, n_c, L_c, B, seed, nc=NC):
    """Chunks of noise; the last one ragged, its data ending late in frame
    0 (where the frame's prefix sums are large) at ``cut`` samples."""
    out_len, pad0, D0, W, m = tds._os_geometry(L_c, n_c, blk)
    rng = np.random.default_rng(seed)
    xq = torch.zeros((B, nc, m * W + D0), dtype=torch.float32)
    xq[:, :, pad0:pad0 + L_c] = torch.from_numpy(
        rng.standard_normal((B, nc, L_c)).astype(np.float32))
    cut = W - n_c // 2
    xq[-1, :, pad0 + cut:] = 0.0                 # ragged chunk
    return xq, out_len, pad0, D0, W, m, cut


@pytest.mark.parametrize("geom", ["560", "129", "16300"])
def test_fwd_prep_fold_source_matches_twin(emu, geom):
    blk, n_c, L_c = GEOMS[geom]
    B = 2
    xq, out_len, pad0, D0, W, m, _ = _prep_inputs(blk, n_c, L_c, B, n_c)
    Rp = dft.half_rp(blk)
    fr = torch.empty((B * NC, m * Rp))
    fi = torch.empty_like(fr)
    a = torch.empty((B, m * W))
    pw = torch.empty_like(a)
    rc = emu.emu_fwd_prep_fold(
        _ptr(xq), _ptr(dft.stage_twiddles(blk, "cpu")),
        _ptr(dft.twiddles(blk, "cpu")), _ptr(fr), _ptr(fi),
        _ptr(a), _ptr(pw), B, NC, xq.shape[2], m, W, D0, pad0, n_c, out_len,
        Rp, blk.bit_length() - 2)
    assert rc == 0
    Fr, Fi, a0, p0 = ref.fwd_prep_fold_ref(xq, NC, n_c, blk, out_len)
    R = blk // 2 + 1
    for k, r in ((fr, Fr), (fi, Fi)):
        k, r = k.reshape(-1, m, Rp), r.reshape(-1, m, Rp)
        assert (k[..., :R] - r[..., :R]).abs().max().item() <= 2e-3
        assert bool((k[..., R:] == 0).all())
    assert torch.allclose(a[:, :out_len], a0[:, :out_len], rtol=0, atol=1e-4)
    assert torch.allclose(pw[:, :out_len], p0[:, :out_len], rtol=1e-4,
                          atol=1e-3)
    assert bool((a[:, out_len:] == 0).all()) and bool(
        (pw[:, out_len:] == 1).all())


@pytest.mark.parametrize("blk,L_c", [(16384, 20000), (32768, 40000)])
def test_fwd_prep_fold_source_zero_power_rule(emu, blk, L_c):
    """The exact zero-power rule (n_c = 560): a window whose multiplexed
    samples are all equal (inside a zero-filled gap longer than the
    template, one crossing the frame boundary, or a stretch where every
    channel holds one constant) has power inf, as in the twin; a stretch
    where each channel is constant at its own value, and the window that
    adds one sample where only channel 0 has that constant, keep a finite
    power.
    Chunk 1 is ragged (a zero tail)."""
    n_c = 560
    xq, out_len, pad0, D0, W, m, _ = _prep_inputs(blk, n_c, L_c, 2, 3)
    g = 2 * n_c + 50
    x0 = xq[0, :, pad0:]
    x0[:, 40:40 + g] = 0.0                          # gap inside frame 0
    x0[:, W - n_c:W + n_c + 7] = 0.0                # gap across frames
    x0[:, 3000:3000 + g] = 0.7                      # channels equal
    x0[0, 2999] = 0.7                               # ... but one sample
    x0[:, 6000:6000 + g] = torch.tensor([[0.1], [0.2], [0.3]])
    Rp = dft.half_rp(blk)
    fr = torch.empty((2 * NC, m * Rp))
    fi = torch.empty_like(fr)
    a = torch.empty((2, m * W))
    pw = torch.empty_like(a)
    rc = emu.emu_fwd_prep_fold(
        _ptr(xq), _ptr(dft.stage_twiddles(blk, "cpu")),
        _ptr(dft.twiddles(blk, "cpu")), _ptr(fr), _ptr(fi),
        _ptr(a), _ptr(pw), 2, NC, xq.shape[2], m, W, D0, pad0, n_c, out_len,
        Rp, blk.bit_length() - 2)
    assert rc == 0
    _, _, a0, p0 = ref.fwd_prep_fold_ref(xq, NC, n_c, blk, out_len)
    k, r = pw[:, :out_len], p0[:, :out_len]
    assert torch.equal(torch.isinf(k), torch.isinf(r))
    assert int(torch.isinf(r[0]).sum()) == 2 * (g - n_c + 1) + n_c + 8
    assert bool(torch.isinf(r[1, -100:]).all())     # the ragged tail
    fin = torch.isfinite(r)
    assert torch.allclose(k[fin], r[fin], rtol=1e-4, atol=1e-3)
    assert torch.allclose(a[:, :out_len], a0[:, :out_len], rtol=0, atol=1e-4)


@pytest.mark.parametrize("geom,mode,S,D,emit_ds", [
    ("560", "sub", 1, 2, True), ("560", "net", 2, 1, False),
    ("16300", "sub", 1, 1, True), ("560", "net", 1, 1, True),
    ("560", "net", 2, 3, True), ("560", "sub", 3, 1, False)])
def test_spec_ds_fold_source_matches_twin(emu, geom, mode, S, D, emit_ds):
    """spec_ds_fold (B1) against its twin. At blk 16384 a block runs two
    transforms side by side: two dims of a row (D = 2; D = 3 leaves one
    side idle in the last step) or, at D = 1, two templates of a chunk
    (S = 2; S = 1 and S = 3 leave one side without a template)."""
    blk, n_c, L_c = GEOMS[geom]
    B = 2
    xq, out_len, pad0, D0, W, m, cut = _prep_inputs(blk, n_c, L_c, B, 7)
    Fr, Fi, a, pw = ref.fwd_prep_fold_ref(xq, NC, n_c, blk, out_len)
    rng = np.random.default_rng(8)
    U_list = [np.linalg.qr(rng.standard_normal((NC * n_c, D)))[0].T
              for _ in range(S)]
    bank = tds.build_bank(U_list, NC, NC * L_c, "cpu", block_fft=blk)
    ur, ui = tds.bank_spec_pair(bank)
    su = bank["sum_u"].T.contiguous()
    nv = torch.tensor([0 if mode == "net" else out_len, cut - n_c + 1],
                      dtype=torch.int32)
    BS = B * S
    ds = torch.empty((BS, m * W)) if emit_ds else None
    pyr = torch.empty((BS, m * (W // 128)))
    hist = torch.zeros((BS, 400), dtype=torch.int32)
    rc = emu.emu_spec_ds_fold(
        _ptr(ur), _ptr(ui), _ptr(Fr), _ptr(Fi), _ptr(a), _ptr(pw), _ptr(su),
        _ptr(nv), _ptr(dft.stage_twiddles(blk, "cpu")),
        _ptr(dft.twiddles(blk, "cpu")), _ptr(ds), _ptr(pyr),
        _ptr(hist), B, S, D, NC, m, W, D0, dft.half_rp(blk), 400,
        int(mode == "sub"), blk.bit_length() - 2)
    assert rc == 0
    d0, p0, h0 = ref.spec_ds_fold_ref(ur, ui, Fr, Fi, a, pw, su, nv, mode,
                                      NC, W, D0, blk, nbin=400,
                                      emit_ds=emit_ds)
    assert torch.equal(torch.isfinite(pyr), torch.isfinite(p0))
    fin = torch.isfinite(p0)
    assert fin.any() and (pyr[fin] - p0[fin]).abs().max().item() <= 2e-5
    assert torch.equal(hist.sum(1), h0.sum(1))
    assert (hist - h0).abs().sum().item() <= 2
    if emit_ds:
        assert torch.equal(torch.isfinite(ds), torch.isfinite(d0))
        fin = torch.isfinite(d0)
        assert (ds[fin] - d0[fin]).abs().max().item() <= 2e-5


@pytest.mark.parametrize("nc", [1, 2, 4])
def test_scan_kernel_sources_channel_counts(emu, nc):
    """fwd_prep_fold and spec_ds_fold at channel counts other than three:
    fwd_prep_fold sweeps the channels in groups of three (nc = 4: a full
    group and one channel more), spec_ds_fold runs its general form where
    the channel loop is not unrolled. One chunk, ragged (a zero tail), with
    a stretch where every channel holds one constant (power inf);
    tolerances as above."""
    blk, n_c, L_c = GEOMS["560"]
    xq, out_len, pad0, D0, W, m, _ = _prep_inputs(blk, n_c, L_c, 1, 40 + nc,
                                                  nc=nc)
    xq[0, :, pad0 + 2000:pad0 + 2000 + 2 * n_c] = 0.25
    Rp = dft.half_rp(blk)
    fr = torch.empty((nc, m * Rp))
    fi = torch.empty_like(fr)
    a = torch.empty((1, m * W))
    pw = torch.empty_like(a)
    stage, tw = dft.stage_twiddles(blk, "cpu"), dft.twiddles(blk, "cpu")
    log2m = blk.bit_length() - 2
    assert emu.emu_fwd_prep_fold(
        _ptr(xq), _ptr(stage), _ptr(tw), _ptr(fr), _ptr(fi), _ptr(a),
        _ptr(pw), 1, nc, xq.shape[2], m, W, D0, pad0, n_c, out_len, Rp,
        log2m) == 0
    Fr, Fi, a0, p0 = ref.fwd_prep_fold_ref(xq, nc, n_c, blk, out_len)
    R = blk // 2 + 1
    for k, r in ((fr, Fr), (fi, Fi)):
        k, r = k.reshape(-1, m, Rp), r.reshape(-1, m, Rp)
        assert (k[..., :R] - r[..., :R]).abs().max().item() <= 2e-3
    assert torch.allclose(a[:, :out_len], a0[:, :out_len], rtol=0, atol=1e-4)
    k, r = pw[:, :out_len], p0[:, :out_len]
    assert torch.equal(torch.isinf(k), torch.isinf(r))
    assert bool(torch.isinf(r[0, 2000:2000 + n_c + 1]).all())
    assert bool(torch.isfinite(r[0, :1400]).all())
    fin = torch.isfinite(r)
    assert torch.allclose(k[fin], r[fin], rtol=1e-4, atol=1e-3)
    rng = np.random.default_rng(nc)
    D = 2
    U = np.linalg.qr(rng.standard_normal((nc * n_c, D)))[0].T
    bank = tds.build_bank([U], nc, nc * L_c, "cpu", block_fft=blk)
    ur, ui = tds.bank_spec_pair(bank)
    su = bank["sum_u"].T.contiguous()
    nv = torch.tensor([out_len], dtype=torch.int32)
    ds = torch.empty((1, m * W))
    pyr = torch.empty((1, m * (W // 128)))
    hist = torch.zeros((1, 400), dtype=torch.int32)
    assert emu.emu_spec_ds_fold(
        _ptr(ur), _ptr(ui), _ptr(Fr), _ptr(Fi), _ptr(a0), _ptr(p0), _ptr(su),
        _ptr(nv), _ptr(stage), _ptr(tw), _ptr(ds), _ptr(pyr), _ptr(hist), 1,
        1, D, nc, m, W, D0, Rp, 400, 1, log2m) == 0
    d0, y0, h0 = ref.spec_ds_fold_ref(ur, ui, Fr, Fi, a0, p0, su, nv, "sub",
                                      nc, W, D0, blk, nbin=400)
    assert torch.equal(torch.isfinite(ds), torch.isfinite(d0))
    fin = torch.isfinite(d0)
    assert (ds[fin] - d0[fin]).abs().max().item() <= 2e-5
    assert (pyr - y0)[torch.isfinite(y0)].abs().max().item() <= 2e-5
    assert torch.equal(hist.sum(1), h0.sum(1))


@pytest.mark.parametrize("blk", [16384, 32768])
def test_block_transforms_source_match_twins(emu, blk):
    """rfft_ct (B4) and irfft_ct (B5, on the register core's inverse):
    four rows, one of them a short signal in zeros and one all zeros; the
    inverse also gets nonzero imaginary parts at bins 0 and n/2, which it
    must ignore as torch.fft.irfft does, comes back exactly 0 on the zero
    row, and takes a single row (N = 1) alike."""
    rng = np.random.default_rng(blk)
    x = torch.from_numpy(rng.standard_normal((4, blk)).astype(np.float32))
    x[2, 100:] = 0.0
    x[3] = 0.0
    tw = dft.twiddles(blk, "cpu")
    stage = dft.stage_twiddles(blk, "cpu")
    log2m = blk.bit_length() - 2
    R = blk // 2 + 1
    out = torch.empty((4, R), dtype=torch.complex64)
    assert emu.emu_rfft_ct(_ptr(x), _ptr(stage), _ptr(tw), _ptr(out), 4,
                           blk, 1, blk, log2m) == 0
    ref_f = ref.rfft_ct_fused_ref(x, blk)
    assert (out - ref_f).abs().max().item() <= 2e-3
    spec = ref_f.clone()
    spec[:3, 0] += 0.5j
    spec[:3, -1] -= 0.25j
    back = torch.full((4, blk), float("nan"))
    assert emu.emu_irfft_ct(_ptr(spec), _ptr(stage), _ptr(tw), _ptr(back),
                            4, log2m) == 0
    want = ref.irfft_ct_fused_ref(spec, blk)
    scale = want[:3].abs().amax(dim=1, keepdim=True)
    assert ((back[:3] - want[:3]).abs() / scale).max().item() <= 2e-5
    assert (back - x).abs().max().item() <= 1e-5
    assert bool((back[3] == 0).all())
    one = torch.full((1, blk), float("nan"))
    assert emu.emu_irfft_ct(_ptr(spec[1:2].contiguous()), _ptr(stage),
                            _ptr(tw), _ptr(one), 1, log2m) == 0
    assert torch.equal(one[0], back[1])


@pytest.mark.parametrize("blk,nbin,grouped", [
    (16384, 0, True), (16384, 400, False), (32768, 400, True)])
def test_ds_finalize_os_fold_source_matches_twin(emu, blk, nbin, grouped):
    """ds_finalize_os_fold (B3) on random inverse blocks: stats per chunk
    shared by S = 2 template rows (``grouped``) or one stats row per DS
    row; chunk 0 empty (nv <= 0), chunk 1 ragged, zero power at a few
    positions (DS 0 there)."""
    rng = np.random.default_rng(nbin + blk)
    B, S, D, m = 2, 2, 2, 2
    head = 3072 if blk == 16384 else 16384
    W = blk - head
    BS = B * S
    cb = torch.from_numpy(
        rng.standard_normal((BS * D, m, blk)).astype(np.float32) * 4)
    G = B if grouped else BS
    a = torch.from_numpy(rng.standard_normal((G, m * W)).astype(np.float32))
    pw = torch.from_numpy(
        rng.uniform(20, 200, (G, m * W)).astype(np.float32))
    pw[:, 5:9] = 0.0
    su = torch.from_numpy(rng.standard_normal(BS * D).astype(np.float32))
    su[1::D] = 0.0                                 # a masked basis slot
    nv_chunk = [-5, W + 1000]
    group = S if grouped else 1
    nv = torch.tensor(nv_chunk if grouped else
                      [nv_chunk[r // S] for r in range(BS)],
                      dtype=torch.int32)
    ds = torch.empty((BS, m * W))
    pyr = torch.empty((BS, m * W // 128))
    hist = torch.zeros((BS, max(nbin, 1)), dtype=torch.int32)
    rc = emu.emu_ds_finalize_os_fold(
        _ptr(cb), _ptr(a), _ptr(pw), _ptr(su), _ptr(nv), _ptr(ds), _ptr(pyr),
        _ptr(hist), BS, D, m, blk, W, head, group, nbin)
    assert rc == 0
    d0, p0, h0 = ref.ds_finalize_os_fold_ref(cb, a, pw, su, nv, head, D, W,
                                             group=group, nbin=nbin)
    for k, r in ((ds, d0), (pyr, p0)):
        assert torch.equal(torch.isfinite(k), torch.isfinite(r))
        fin = torch.isfinite(r)
        assert fin.any()
        assert (k[fin] - r[fin]).abs().max().item() <= 2e-5
    assert bool((ds[S:, 5:9] == 0).all())
    assert bool(torch.isneginf(ds[:S]).all())
    if nbin:
        assert torch.equal(hist.sum(1), h0.sum(1))
        assert (hist - h0).abs().sum().item() <= 2


@pytest.mark.parametrize("blk", [16384, 32768])
def test_rfft_ct_half_source_matches_twin(emu, blk):
    """rfft_ct_half (B6): three rows, one a short signal in zeros; bins
    0..blk/2 against the twin, zeros past them in the padded width."""
    rng = np.random.default_rng(blk + 1)
    x = torch.from_numpy(rng.standard_normal((3, blk)).astype(np.float32))
    x[1, 300:] = 0.0
    Rp = dft.half_rp(blk)
    fr = torch.full((3, Rp), float("nan"))
    fi = torch.full((3, Rp), float("nan"))
    assert emu.emu_rfft_ct_half(_ptr(x), _ptr(dft.stage_twiddles(blk, "cpu")),
                                _ptr(dft.twiddles(blk, "cpu")), _ptr(fr),
                                _ptr(fi), 3, blk, 1, blk, Rp,
                                blk.bit_length() - 2) == 0
    r_re, r_im = ref.rfft_ct_half_ref(x, blk)
    R = blk // 2 + 1
    for k, r in ((fr, r_re), (fi, r_im)):
        assert (k[:, :R] - r[:, :R]).abs().max().item() <= 2e-3
        assert bool((k[:, R:] == 0).all()) and bool((r[:, R:] == 0).all())


@pytest.mark.parametrize("M", [8192, 16384])
def test_fft_regs_core_matches_numpy_fft(emu, M):
    """The register-resident FFT core (fft_regs.cuh) alone: the M-point
    complex forward transform of two rows, one of noise and one a single
    tone plus an impulse, against numpy.fft.fft in float64. Tolerance:
    2e-3 absolute on values up to ~M (the spectra gate of the kernels that
    use it); noise rows measure ~1e-4."""
    rng = np.random.default_rng(M)
    z = rng.standard_normal((2, M)) + 1j * rng.standard_normal((2, M))
    z[1] = 0.1 * np.exp(2j * np.pi * 37 * np.arange(M) / M)
    z[1, 5] += 3.0
    zin = torch.from_numpy(z.astype(np.complex64))
    zout = torch.full((2, M), float("nan"), dtype=torch.complex64)
    n = 2 * M
    assert emu.emu_fft_regs(_ptr(zin), _ptr(dft.stage_twiddles(n, "cpu")),
                            _ptr(zout), 2, n.bit_length() - 2) == 0
    want = np.fft.fft(zin.numpy().astype(np.complex128), axis=1)
    err = np.abs(zout.numpy() - want).max()
    assert np.isfinite(err) and err <= 2e-3


@pytest.mark.parametrize("M", [8192, 16384])
def test_ifft_regs_core_matches_numpy_ifft(emu, M):
    """The inverse register-resident core (fft_regs.cuh irfft_regs_row)
    alone: the pack pre-pass in registers, three passes and the samples
    handed over from registers, on three half spectra of 2M real samples:
    noise; a row whose only nonzero bins are 0, M/2 and M (thread 0's own
    pairs) with imaginary parts at bins 0 and M, which must not count; and
    noise's transform, which must come back as the noise. Against
    numpy.fft.irfft in float64. Tolerance: 2e-5 of the row's largest value
    (the inverse transforms' gate); measured ~3e-7."""
    n = 2 * M
    rng = np.random.default_rng(M + 1)
    spec = rng.standard_normal((3, M + 1)) + 1j * rng.standard_normal(
        (3, M + 1))
    spec[1] = 0.0
    spec[1, [0, M // 2, M]] = [3.0 + 2.0j, 1.0 - 4.0j, -2.0 + 1.0j]
    x2 = rng.standard_normal(n)
    spec[2] = np.fft.rfft(x2)
    sp = torch.from_numpy(spec.astype(np.complex64))
    out = torch.full((3, n), float("nan"))
    assert emu.emu_ifft_regs(_ptr(sp), _ptr(dft.stage_twiddles(n, "cpu")),
                             _ptr(dft.twiddles(n, "cpu")), _ptr(out), 3,
                             n.bit_length() - 2) == 0
    want = np.fft.irfft(sp.numpy().astype(np.complex128), n=n, axis=1)
    err = np.abs(out.numpy() - want).max(axis=1)
    scale = np.abs(want).max(axis=1)
    assert np.isfinite(err).all() and (err <= 2e-5 * scale).all()
    assert np.abs(out[2].numpy() - x2).max() <= 1e-5


def _framed_source(blk, R, m, W, seed):
    """Rows [R, Lp] of noise holding m overlapping frames of blk samples
    at stride W, Lp longer than the frames need."""
    Lp = (m - 1) * W + blk + 256
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((R, Lp)).astype(np.float32))


# (blk, rows R, frames m, stride W): one transform; a row count that no
# number of resident rows divides; overlapping frames in rows longer than
# they need (W < blk, Lp > n), at both block lengths
FRAME_CASES = [(16384, 1, 1, None), (32768, 1, 1, None),
               (16384, 5, 1, None), (16384, 2, 3, 7296),
               (32768, 1, 3, 26752), (16384, 3, 2, 128)]


@pytest.mark.parametrize("blk,R,m,W", FRAME_CASES)
def test_rfft_ct_source_frames_match_twin(emu, blk, R, m, W):
    """rfft_ct (B4) on contiguous rows (W None) and on frames read in
    place, against unfold + the twin; nothing written past the output."""
    x = (_framed_source(blk, R, m, W, blk + R) if W else torch.from_numpy(
        np.random.default_rng(R).standard_normal((R, blk)).astype(
            np.float32)))
    Lp, Wk = x.shape[1], W or blk
    N, Rb = R * m, blk // 2 + 1
    out = torch.full((N * Rb + 1,), float("nan"), dtype=torch.complex64)
    assert emu.emu_rfft_ct(_ptr(x), _ptr(dft.stage_twiddles(blk, "cpu")),
                           _ptr(dft.twiddles(blk, "cpu")), _ptr(out), N, Lp,
                           m, Wk, blk.bit_length() - 2) == 0
    assert bool(torch.isnan(out[-1].real))
    want = ref.rfft_ct_fused_ref(x.unfold(1, blk, Wk)[:, :m].reshape(N, blk),
                                 blk)
    assert (out[:-1].reshape(N, Rb) - want).abs().max().item() <= 2e-3


@pytest.mark.parametrize("blk,R,m,W", FRAME_CASES)
def test_rfft_ct_half_source_frames_match_twin(emu, blk, R, m, W):
    """rfft_ct_half (B6) on contiguous rows and on frames read in place,
    against unfold + the twin; zeros past blk/2 exact."""
    x = (_framed_source(blk, R, m, W, blk + R + 1) if W else torch.from_numpy(
        np.random.default_rng(R + 9).standard_normal((R, blk)).astype(
            np.float32)))
    Lp, Wk = x.shape[1], W or blk
    N, Rp, Rb = R * m, dft.half_rp(blk), blk // 2 + 1
    fr = torch.full((N, Rp), float("nan"))
    fi = torch.full((N, Rp), float("nan"))
    assert emu.emu_rfft_ct_half(_ptr(x), _ptr(dft.stage_twiddles(blk, "cpu")),
                                _ptr(dft.twiddles(blk, "cpu")), _ptr(fr),
                                _ptr(fi), N, Lp, m, Wk, Rp,
                                blk.bit_length() - 2) == 0
    r_re, r_im = ref.rfft_ct_half_ref(
        x.unfold(1, blk, Wk)[:, :m].reshape(N, blk), blk)
    for k, r in ((fr, r_re), (fi, r_im)):
        assert (k[:, :Rb] - r[:, :Rb]).abs().max().item() <= 2e-3
        assert bool((k[:, Rb:] == 0).all())


def _os_block_inputs(blk, S, D, m, seed):
    """Random inverse blocks cb [S*D, m, blk] and one chunk's stats row
    a, power [m*W] with zero power at a few positions, a masked basis
    slot, and positions planted to give DS exactly 1.0 (a = 0, power 1,
    the row's basis rows 1 and 0) and exactly 9.0 (> 1)."""
    rng = np.random.default_rng(seed)
    head = 3072 if blk == 16384 else 16384
    W = blk - head
    cb = torch.from_numpy(
        rng.standard_normal((S * D, m, blk)).astype(np.float32) * 4)
    a = torch.from_numpy(rng.standard_normal(m * W).astype(np.float32))
    pw = torch.from_numpy(rng.uniform(20, 200, m * W).astype(np.float32))
    pw[5:9] = 0.0
    su = torch.from_numpy(rng.standard_normal(S * D).astype(np.float32))
    su[1::D] = 0.0
    for t, v in ((130, 1.0), (W + 7, 1.0), (300, 3.0)):
        i, tt = divmod(t, W)
        a[t], pw[t] = 0.0, 1.0
        cb[:, i, head + tt] = 0.0
        cb[0::D, i, head + tt] = v
    return cb, a, pw, su, head, W


def _run_os_scan(emu, cb, a, pw, su, nv, head, D, W, nbin):
    """ds_finalize_os_scan's source and its twin: ((ds, pyr, hist),
    (twin's ds, pyr, hist))."""
    S, m = cb.shape[0] // D, cb.shape[1]
    nvt = torch.tensor([nv], dtype=torch.int32)
    ds = torch.full((S, m * W), float("nan"))
    pyr = torch.full((S, m * W // 128), float("nan"))
    hist = torch.zeros((S, max(nbin, 1)), dtype=torch.int32)
    rc = emu.emu_ds_finalize_os_scan(
        _ptr(cb), _ptr(a), _ptr(pw), _ptr(su), _ptr(nvt), _ptr(ds),
        _ptr(pyr), _ptr(hist), S, D, m, cb.shape[2], W, head, nbin)
    assert rc == 0
    return (ds, pyr, hist), ref.ds_finalize_os_scan_ref(
        cb, a, pw, su, nvt, head, D, W, nbin=nbin)


def _check_os_scan(got, want, nbin):
    for k, r in zip(got[:2], want[:2]):
        assert torch.equal(torch.isfinite(k), torch.isfinite(r))
        fin = torch.isfinite(r)
        if fin.any():
            assert (k[fin] - r[fin]).abs().max().item() <= 2e-5
    if nbin:
        assert torch.equal(got[2].sum(1), want[2].sum(1))
        assert (got[2] - want[2]).abs().sum().item() <= 2


@pytest.mark.parametrize("blk,nbin,nv", [
    (16384, 0, 20000), (16384, 400, -3), (16384, 400, 20000),
    (32768, 400, 20000)])
def test_ds_finalize_os_scan_source_matches_twin(emu, blk, nbin, nv):
    """ds_finalize_os_scan (B7): one chunk's S = 3 rows sharing its stats,
    valid length nv (<= 0: every position -inf; else ragged inside block
    1), DS 0 at zero power, v == 1.0 in the last bin, v > 1 dropped."""
    S, D, m = 3, 2, 2
    cb, a, pw, su, head, W = _os_block_inputs(blk, S, D, m, nbin + blk)
    if nv > 0:
        nv = W + 1000
    got, want = _run_os_scan(emu, cb, a, pw, su, nv, head, D, W, nbin)
    _check_os_scan(got, want, nbin)
    ds, pyr, hist = got
    if nv <= 0:
        assert bool(torch.isneginf(ds).all()) and bool(
            torch.isneginf(pyr).all())
    else:
        assert bool((ds[:, 5:9] == 0).all())
        assert bool((ds[0, [130, W + 7]] == 1.0).all())
        assert float(ds[0, 300]) == 9.0
        assert bool(torch.isneginf(ds[:, nv:]).all())
    if nbin and nv > 0:
        assert int(hist[0, -1]) >= 2 and int(want[2][0, -1]) >= 2


@pytest.mark.parametrize("D", [1, 3, 5])
def test_ds_finalize_os_scan_source_dims(emu, D):
    """ds_finalize_os_scan (B7) at D = 1 and 3 (compile-time dims) and 5
    (the general form, four dims a load step), ragged: the twin within
    2e-5, histogram totals exact."""
    S, m = 3, 2
    cb, a, pw, su, head, W = _os_block_inputs(16384, S, D, m, 40 + D)
    got, want = _run_os_scan(emu, cb, a, pw, su, W + 3000, head, D, W, 400)
    _check_os_scan(got, want, 400)
    assert bool((got[0][:, 5:9] == 0).all())
    assert bool(torch.isneginf(got[0][:, W + 3000:]).all())


@pytest.mark.parametrize("blk", [16384, 32768])
def test_ds_finalize_os_scan_source_noise_in_bin0(emu, blk):
    """ds_finalize_os_scan (B7) on noise-like inputs whose DS (~3e-4) puts
    nearly every sample into bin 0, where the per-thread run counts carry
    the histogram: counts equal to the twin's, bin 0 holding nearly all."""
    S, D, m = 2, 1, 2
    rng = np.random.default_rng(blk + 9)
    head = 3072 if blk == 16384 else 16384
    W = blk - head
    cb = torch.from_numpy(
        rng.standard_normal((S * D, m, blk)).astype(np.float32) * 1.7e-2)
    a = torch.from_numpy(rng.standard_normal(m * W).astype(np.float32))
    pw = torch.from_numpy(rng.uniform(0.9, 1.1, m * W).astype(np.float32))
    su = torch.from_numpy(rng.standard_normal(S * D).astype(np.float32)
                          * 1e-3)
    got, want = _run_os_scan(emu, cb, a, pw, su, m * W - 500, head, D, W,
                             400)
    _check_os_scan(got, want, 400)
    assert torch.equal(got[2], want[2])
    assert int(want[2][:, 0].sum()) >= 0.95 * S * (m * W - 500)


# the D = 2 cases keep the ids they had before D was a parameter
OS_CASES = [pytest.param(blk, D,
                         id=str(blk) if D == 2 else "%d-D%d" % (blk, D))
            for blk in (16384, 32768) for D in (1, 2, 3, 4, 5)]


@pytest.mark.parametrize("blk,D", OS_CASES)
def test_ds_finalize_os_source_matches_twin(emu, blk, D):
    """ds_finalize_os (B8) on the shared body without the scan (D = 1..4
    compile-time dims, 5 the general form): no mask, no maxima; DS 0 at
    zero power, the planted exact values, the twin within 2e-5
    everywhere."""
    S, m = 2, 3
    cb, a, pw, su, head, W = _os_block_inputs(blk, S, D, m,
                                              blk + 5 + 10 * (D - 2))
    _check_os(emu, cb, a, pw, su, head, D, W)


def _check_os(emu, cb, a, pw, su, head, D, W):
    S, m, blk = cb.shape[0] // D, cb.shape[1], cb.shape[2]
    ds = torch.full((S, m * W), float("nan"))
    rc = emu.emu_ds_finalize_os(_ptr(cb), _ptr(a), _ptr(pw), _ptr(su),
                                _ptr(ds), S, D, m, blk, W, head)
    assert rc == 0
    d0 = ref.ds_finalize_os_ref(cb, a, pw, su, head, D, W)
    assert bool(torch.isfinite(ds).all())
    assert (ds - d0).abs().max().item() <= 2e-5
    assert bool((ds[:, 5:9] == 0).all())
    assert bool((ds[0, [130, W + 7] if m > 1 else [130]] == 1.0).all())
    assert float(ds[0, 300]) == 9.0


@pytest.mark.parametrize("D", [1, 5])
def test_ds_finalize_os_source_one_block(emu, D):
    """ds_finalize_os (B8) on a grid of one thread block (S * m = 1):
    W // 128 = 209 groups, as at one D1 chunk, over the block's 8 warps
    (a ragged last step), against the twin."""
    blk, W = 32768, 26752
    rng = np.random.default_rng(D + 70)
    cb = torch.from_numpy(
        rng.standard_normal((D, 1, blk)).astype(np.float32) * 4)
    a = torch.from_numpy(rng.standard_normal(W).astype(np.float32))
    pw = torch.from_numpy(rng.uniform(20, 200, W).astype(np.float32))
    pw[5:9] = 0.0
    su = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    head = blk - W
    for t, v in ((130, 1.0), (300, 3.0)):
        a[t], pw[t] = 0.0, 1.0
        cb[:, 0, head + t] = 0.0
        cb[0, 0, head + t] = v
    _check_os(emu, cb, a, pw, su, head, D, W)


@pytest.mark.parametrize("nbin,L", [(400, 20000), (100, 8192), (1, 3000)])
def test_hist_uniform_source_matches_twin(emu, nbin, L):
    """hist_uniform (B9): counts equal to the twin's exactly (the same
    float32 floor rule); 1.0 in the last bin; negative, > 1, -inf and NaN
    values dropped; a row of only dropped values counts nothing."""
    rng = np.random.default_rng(nbin + L)
    ds = torch.from_numpy(rng.uniform(-0.1, 1.1, (3, L)).astype(np.float32))
    ds[0, :10] = 1.0
    ds[0, 10:20] = 0.0
    ds[1, ::7] = float("-inf")
    ds[1, 3::11] = float("nan")
    ds[1, 5::13] = float(np.nextafter(np.float32(1), np.float32(2)))
    ds[2] = float("-inf")
    hist = torch.zeros((3, nbin), dtype=torch.int32)
    assert emu.emu_hist_uniform(_ptr(ds), _ptr(hist), 3, L, nbin) == 0
    h0 = ref.hist_uniform_ref(ds, nbin)
    assert torch.equal(hist, h0)
    assert int(hist[0, -1]) >= 10 and int(hist[2].sum()) == 0
    v = ds.numpy()
    keep = (v >= 0) & (v <= 1)
    assert np.array_equal(hist.sum(1).numpy(), keep.sum(1))


@pytest.mark.parametrize("S,D,L", [(3, 2, 2500), (2, 4, 1024), (2, 3, 1)])
def test_ds_finalize_source_matches_twin(emu, S, D, L):
    """ds_finalize (B10): the full-length finalize against its twin at L
    not a multiple of the kernel's tile (2500), exactly one tile (1024) and
    L = 1; power inf (DS 0) at a few positions, a masked basis slot (cc row
    0, sum_u 0), a padded row (every cc row and sum_u 0: DS 0), a planted
    exact DS of 9.0, and no write past the [S, L] output."""
    rng = np.random.default_rng(S * L + D)
    cc = torch.from_numpy(
        (rng.standard_normal((S, D, L)) * 4).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal(L).astype(np.float32))
    pw = torch.from_numpy(rng.uniform(20, 200, L).astype(np.float32))
    su = torch.from_numpy(rng.standard_normal((S, D)).astype(np.float32))
    cc[0, D - 1] = 0.0
    su[0, D - 1] = 0.0
    cc[S - 1] = 0.0
    su[S - 1] = 0.0
    pw[3:7] = float("inf")
    t = L // 2 if L > 7 else 0
    a[t], pw[t] = 0.0, 1.0
    cc[0, :, t] = 0.0
    cc[0, 0, t] = 3.0
    out = torch.full((S * L + 1,), float("nan"))     # + a guard element
    assert emu.emu_ds_finalize(_ptr(cc), _ptr(a), _ptr(pw), _ptr(su),
                               _ptr(out), S, D, L) == 0
    assert bool(torch.isnan(out[-1]))                # nothing past [S, L]
    ds = out[:-1].reshape(S, L)
    d0 = ref.ds_finalize_ref(cc, a, pw, su)
    assert bool(torch.isfinite(ds).all())
    assert (ds - d0).abs().max().item() <= 2e-5
    assert float(ds[0, t]) == 9.0
    assert bool((ds[S - 1] == 0).all())
    if L > 7:
        assert bool((ds[:, 3:7] == 0).all())
