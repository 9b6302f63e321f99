"""
A/B timing of copies of detex_torch on one CUDA card: for each tree given
(a directory holding a ``detex_torch/`` package and ``chip_smoke.py``, e.g.
a ``git archive`` of another commit), in the order given and each in a
process of its own, build its kernels and time

  - fwd_prep_fold, spec_ds_fold (summary-only, mode "sub") and the
    summary-only phase-A scan at chip_smoke's phase-A shape (256 two-hour
    chunks at 100 Hz on three channels, one 4-dim subspace of 30 s
    templates); spec_ds_fold also at phase B's shape (mode "net", 128
    one-dim templates of 30 s on 8 chunks of 3720 s, the DS array written);
  - the card's L2 rate, as the yardstick of spec_ds_fold's second floor: a
    16 MiB device-to-device copy repeated in place, which stays in the 50 MB
    L2 (bytes read plus bytes written over the time);
  - the forward block transforms rfft_ct_fused and rfft_ct_half on
    contiguous rows: rfft_ct_fused at the dense re-verify's 1,296 rows of
    16,384, at the per-chunk route's 84 rows of 16,384 and 42 rows of
    32,768, and at 648 rows of 32,768; rfft_ct_half at the unfused prep's
    4,704 rows of 16,384 and at 2,352 rows of 32,768;
  - the same transforms from the padded demuxed batch the paths hold (the
    framed form: 1,296 frames at stride 13,312 of 8 x 3 rows, 4,704 frames
    at stride 7,296 of 16 x 3 rows), through dft.rfft_frames /
    dft.rfft_pair_frames where the tree has them and through the tree's
    unfold + copy + transform otherwise;
  - the per-chunk route's kernels: irfft_ct_fused at the dense
    re-verify's 1,728 rows of 16,384, at one D2 chunk's 3,584 rows of
    16,384 and at one D1 chunk's 1,792 rows of 32,768, beside
    torch.fft.irfft; ds_finalize_os_scan at one D2 chunk (128 one-dim 30 s
    templates on a 3720 s noise chunk, made by the tree's chip_smoke as
    phase D2 makes them) with nbin 0 and 400; ds_finalize_os_fold at phase
    C's re-verify shape (cb [32, 54, 16384], nbin 0); and ds_finalize_os
    on seeded noise at one D1 chunk's shape (cb [128, 14, 32768]) and at
    D = 2 and 5 on the same blocks (cb [128, ...] and [160, ...]);
  - the tree's own chip_smoke phases C (scan + dense re-verify), D3 (the
    fused scan behind the unfused prep), D2 and D1 (the per-chunk route),
    B (serving) and E1 (raw-chunk serving with the device prep).

Kernels by CUDA events (mean of ``reps`` launches after a 0.5 s warm-up);
shapes under one wave of the card (fewer rows than SMs), where the host's
launch rate and not the kernel would be timed, by CUDA events around the
replay of a CUDA graph of 50 launches; phases by the host clock (best of 3
or 2 after a warm-up).

    python3 scripts/ab_torch_variants.py \\
        [--transforms | --scan-kernels | --chunk-kernels] \\
        TREE_A TREE_B TREE_B TREE_A

``--transforms`` times the forward block transforms only, ``--scan-kernels``
fwd_prep_fold, spec_ds_fold and the L2 copy only, ``--chunk-kernels`` the
per-chunk route's kernels and their controls only. Give the trees in
turns (A, B, B, A) so that drift on the card shows: two commits compare
only inside one command on one card. The other commit is unpacked into a
directory that .gitignore lists:

    mkdir -p _chipwork/parent
    git archive <commit> detex_torch chip_smoke.py | tar -x -C _chipwork/parent
    python3 scripts/ab_torch_variants.py \\
        . _chipwork/parent _chipwork/parent .
"""
import os
import subprocess
import sys
import tempfile
import time

NC = 3
LC = 2160000            # two hours at 100 Hz on three channels
N = 9000                # 30 s templates


def cuda_ms(torch, fn, reps, warm_s=0.5):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        fn()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps=50):
    """Device milliseconds of fn() without the host's launch cost: CUDA
    events around one replay of a CUDA graph of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def transforms(torch, ck, dft, tds, dev, say):
    """The forward block transforms on contiguous rows and in the framed
    form."""
    g = torch.Generator(device=dev).manual_seed(5)
    for name, rows, n in (("rfft_ct_fused", 1296, 16384),
                          ("rfft_ct_fused", 84, 16384),
                          ("rfft_ct_fused", 42, 32768),
                          ("rfft_ct_fused", 648, 32768),
                          ("rfft_ct_half", 4704, 16384),
                          ("rfft_ct_half", 2352, 32768)):
        x = torch.randn((rows, n), generator=g, device=dev)
        fn = getattr(ck, name)
        if rows < 132:
            ms = graph_ms(torch, lambda: fn(x, n))
            lib = graph_ms(torch, lambda: torch.fft.rfft(x, n=n))
        else:
            ms = cuda_ms(torch, lambda: fn(x, n), 20)
            lib = cuda_ms(torch, lambda: torch.fft.rfft(x, n=n), 20)
        say("%s %d x %d: %.4f ms (torch.fft.rfft %.4f ms)%s"
            % (name, rows, n, ms, lib,
               " [graph replay]" if rows < 132 else ""))
        del x
    blk = 16384
    Rp = dft.half_rp(blk)
    for name, B, n_c in (("rfft_ct_fused", 8, 3000), ("rfft_ct_half", 16,
                                                      9000)):
        _, _, D0, W, m = tds._os_geometry(LC // NC, n_c, blk)
        xq = torch.randn((B, NC, m * W + D0), generator=g, device=dev)
        if name == "rfft_ct_fused":
            if hasattr(dft, "rfft_frames"):
                fn = lambda: dft.rfft_frames(xq, blk, W, m)
            else:
                fn = lambda: dft.rfft_ct(xq.unfold(2, blk, W), blk)
        elif hasattr(dft, "rfft_pair_frames"):
            fn = lambda: dft.rfft_pair_frames(xq, blk, W, m, Rp)
        else:
            fn = lambda: dft.rfft_pair(
                xq.unfold(2, blk, W).reshape(B * NC * m, blk), blk, Rp)
        ms = cuda_ms(torch, fn, 20)
        lib = cuda_ms(torch, lambda: torch.fft.rfft(
            xq.unfold(2, blk, W).contiguous(), n=blk), 20)
        say("%s framed, %d frames at stride %d of %d rows: %.4f ms "
            "(contiguous() + torch.fft.rfft %.4f ms)"
            % (name, B * NC * m, W, B * NC, ms, lib))
        del xq


def chunk_kernels(torch, ck, cs, dev, say, tmp):
    """irfft_ct_fused at three shapes, ds_finalize_os_scan at one D2 chunk
    (nbin 0 and 400), ds_finalize_os_fold at phase C's re-verify shape,
    ds_finalize_os at one D1 chunk (alone and with what the chunk does
    next, d1_tail) and at D = 2 and 5 (its bound from chip_smoke's peaks
    beside it); returns the D2 setup
    (chip_smoke.serving_setup) for phase D2."""
    g = torch.Generator(device=dev).manual_seed(6)
    for rows, n in ((1728, 16384), (3584, 16384), (1792, 32768)):
        spec = torch.view_as_complex(torch.randn((rows, n // 2 + 1, 2),
                                                 generator=g, device=dev))
        say("irfft_ct_fused %d x %d: %.4f ms (torch.fft.irfft %.4f ms)"
            % (rows, n, cuda_ms(torch, lambda: ck.irfft_ct_fused(spec, n),
                                20),
               cuda_ms(torch, lambda: torch.fft.irfft(spec, n=n), 20)))
        del spec
    d2 = cs.serving_setup(dev, tmp, "d2", 128, 64, 30.0, 9)
    fin = cs.chunk_finalize_inputs(d2["bank"],
                                   torch.as_tensor(d2["X"][0], device=dev))
    nv = torch.tensor([fin[-1]], dtype=torch.int32, device=dev)
    args = fin[:4] + (nv,) + fin[4:7]
    for nbin in (0, 400):
        say("ds_finalize_os_scan cb %s (D2 chunk) nbin %d: %.4f ms"
            % (tuple(fin[0].shape), nbin, cuda_ms(
                torch, lambda: ck.ds_finalize_os_scan(*args, nbin=nbin), 20)))
    del fin, args
    torch.cuda.empty_cache()
    W = 13312
    cb = 0.01 * torch.randn((32, 54, 16384), generator=g, device=dev)
    a = torch.randn((8, 54 * W), generator=g, device=dev)
    pw = 0.5 + torch.rand((8, 54 * W), generator=g, device=dev)
    su = torch.randn(32, generator=g, device=dev)
    nvf = torch.full((8,), 717001, dtype=torch.int32, device=dev)
    say("ds_finalize_os_fold cb %s nbin 0: %.4f ms"
        % (tuple(cb.shape), cuda_ms(torch, lambda: ck.ds_finalize_os_fold(
            cb, a, pw, su, nvf, 3072, 4, W), 20)))
    del cb, a, pw, su, nvf
    W, m = 26752, 14
    a = torch.randn(m * W, generator=g, device=dev)
    pw = 0.5 + torch.rand(m * W, generator=g, device=dev)
    for S, D in ((128, 1), (64, 2), (32, 5)):
        cb = 0.01 * torch.randn((S * D, m, 32768), generator=g, device=dev)
        su = torch.randn(S * D, generator=g, device=dev)
        samples = S * m * W
        bound = max((samples * (D + 1) + 2 * m * W + S * D) * 4 / 3.35e12,
                    samples * (3 * D + 1) / 67e12) * 1e3
        say("ds_finalize_os cb %s (D = %d%s): %.4f ms (bound %.4f ms)"
            % (tuple(cb.shape), D, ", one D1 chunk" if D == 1 else "",
               cuda_ms(torch, lambda: ck.ds_finalize_os(
                   cb, a, pw, su, 6016, D, W), 20), bound))
        if D == 1:
            say("ds_finalize_os + mask + maxima + hist_uniform (one D1 "
                "chunk, as os_block_scan and the scan's histogram): %.4f ms"
                % cuda_ms(torch, lambda: d1_tail(torch, ck, cb, a, pw, su,
                                                 W), 20))
        del cb, su
    del a, pw
    torch.cuda.empty_cache()
    return d2


def d1_tail(torch, ck, cb, a, pw, su, W):
    """What a D1 chunk does with B8's output: the -inf mask past the valid
    length and the 128-sample maxima (ops/ds.os_block_scan), then the
    histogram (hist_uniform), which all read the DS rows again."""
    ds = ck.ds_finalize_os(cb, a, pw, su, 6016, 1, W)
    pos = torch.arange(ds.shape[1], device=ds.device)
    ds = torch.where(pos[None, :] < ds.shape[1] - 5000, ds,
                     torch.full_like(ds, float("-inf")))
    ds.reshape(ds.shape[0], -1, 128).amax(dim=-1)
    ck.hist_uniform(ds, 400)


def l2_copy_gbs(torch, dev, mib=16, reps=200):
    """GB/s (read + written) of a device-to-device copy of ``mib`` MiB
    repeated in place: source and destination stay in L2."""
    src = torch.empty(mib << 20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    ms = cuda_ms(torch, lambda: dst.copy_(src), reps)
    return 2 * src.numel() / (ms * 1e-3) / 1e9


def scan_kernels(torch, np, ck, tds, dev, say):
    """fwd_prep_fold and spec_ds_fold at phase A's shape, spec_ds_fold at
    phase B's; returns what the phase-A scan needs (X, bank)."""
    q, _ = np.linalg.qr(np.random.default_rng(1).standard_normal((N, 4)))
    bank = tds.build_bank([np.ascontiguousarray(q.T)], NC, LC, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((256, LC), generator=g, device=dev)
    n_c, blk = N // NC, bank["blk_fft"]
    xq, out_len = tds.standardize_demux(X, n_c, NC, blk)
    prep_ms = cuda_ms(torch, lambda: ck.fwd_prep_fold(xq, NC, n_c, blk,
                                                      out_len), 5)
    Fr, Fi, a, power = ck.fwd_prep_fold(xq, NC, n_c, blk, out_len)
    del xq
    _, _, D0, W, _ = tds._os_geometry(LC // NC, n_c, blk)
    ur, ui = tds.bank_spec_pair(bank)
    su = bank["sum_u"].T.contiguous()
    nv = torch.full((256,), out_len, dtype=torch.int32, device=dev)
    spec_a = cuda_ms(torch, lambda: ck.spec_ds_fold(
        ur, ui, Fr, Fi, a, power, su, nv, "sub", NC, W, D0, blk, nbin=400,
        emit_ds=False), 5)
    del Fr, Fi, a, power
    torch.cuda.empty_cache()
    # phase B: 128 one-dim templates, 8 chunks of 3720 s, DS written
    Lb = 3720 * 100 * NC
    rng = np.random.default_rng(2)
    Us = [np.ascontiguousarray(np.linalg.qr(
        rng.standard_normal((N, 1)))[0].T) for _ in range(128)]
    bank_b = tds.build_bank(Us, NC, Lb, dev)
    Xb = torch.randn((8, Lb), generator=g, device=dev)
    Fr, Fi, a, power = tds.os_prep_batch_fused(Xb, n_c, NC, blk)
    out_b, _, D0, W, _ = tds._os_geometry(Lb // NC, n_c, blk)
    ur, ui = tds.bank_spec_pair(bank_b)
    su = bank_b["sum_u"].T.contiguous()
    nv = torch.full((8,), out_b, dtype=torch.int32, device=dev)
    spec_b = cuda_ms(torch, lambda: ck.spec_ds_fold(
        ur, ui, Fr, Fi, a, power, su, nv, "net", NC, W, D0, blk, nbin=400,
        emit_ds=True), 5)
    say("fwd_prep_fold %.3f ms; spec_ds_fold phase-A shape %.3f ms, phase-B "
        "shape (emit_ds) %.3f ms; L2 copy %.0f GB/s"
        % (prep_ms, spec_a, spec_b, l2_copy_gbs(torch, dev)))
    return X, bank


def one(root, only):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import chip_smoke as cs
    from detex_torch.kernels import build
    from detex_torch.ops import cuda_kernels as ck
    from detex_torch.ops import dft
    from detex_torch.ops import ds as tds
    from detex_torch.parallel import scan as tscan
    for mod in (build, cs):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError("imported %s, not from the tree %s"
                               % (mod.__file__, root))

    def say(msg):
        print("%s: %s" % (root, msg), flush=True)

    dev = torch.device("cuda")
    lib = build.load_library()
    with open(os.path.splitext(lib._name)[0] + ".log") as f:
        report = f.read().splitlines()
    for i, line in enumerate(report):       # ptxas: registers, stack, spills
        if "entry function" in line and any(
                k in line for k in ("fwd_prep_fold", "spec_ds_fold",
                                    "irfft_ct", "ds_finalize_os")):
            say("ptxas %s: %s; %s" % (
                line.split("'")[1], report[i + 2].strip(),
                report[i + 3].replace("ptxas info    :", "").strip()))
    if only in (None, "--transforms"):
        transforms(torch, ck, dft, tds, dev, say)
    with tempfile.TemporaryDirectory() as tmp:
        if only in (None, "--chunk-kernels"):
            d2 = chunk_kernels(torch, ck, cs, dev, say, tmp)
        if only in (None, "--scan-kernels"):
            X, bank = scan_kernels(torch, np, ck, tds, dev, say)
        if only is None:
            phases(torch, np, cs, tscan, dev, say, tmp, X, bank, d2)


def phases(torch, np, cs, tscan, dev, say, tmp, X, bank, d2):
    """The summary-only phase-A scan and the tree's chip_smoke phases C,
    D3, D2, D1, B and E1 (host clock, best of the runs after a warm-up)."""
    th = np.full(1, 0.5, np.float32)
    scan = []
    for _ in range(4):                              # first run warms up
        t0 = time.perf_counter()
        tscan.scan_chunks(X, bank, th, NC, 2000, max_trig=16,
                          calc_triggers=False)
        torch.cuda.synchronize()
        scan.append(1e3 * (time.perf_counter() - t0))
    say("phase-A scan best %.3f ms %s"
        % (min(scan[1:]), [round(t, 3) for t in scan[1:]]))
    del X, bank
    torch.cuda.empty_cache()
    pc = cs.phase_c(dev, 256 * 2.0 / 24.0 / (min(scan[1:]) * 1e-3))
    say("phase C best %.3f ms" % (1e3 * pc["s_per_batch"]))
    del pc
    torch.cuda.empty_cache()
    d3 = cs.phase_d3(dev, cs.phase_d3_setup(dev))
    say("phase D3 best %.3f ms" % (1e3 * d3["s_per_launch"]))
    del d3
    torch.cuda.empty_cache()
    say("phase D2 best %.3f ms"
        % (1e3 * cs.serve_and_check("D2", d2)["s_per_request"]))
    del d2
    torch.cuda.empty_cache()
    d1 = cs.serving_setup(dev, tmp, "d1", 128, 32, 60.0, 8,
                          amp=3.0 * np.sqrt(60 * 100.0 * NC))
    say("phase D1 best %.3f ms"
        % (1e3 * cs.serve_and_check("D1", d1)["s_per_request"]))
    del d1
    torch.cuda.empty_cache()
    pb = cs.phase_b(dev, tmp)
    say("phase B best %.3f ms" % (1e3 * pb["s_per_request"]))
    e1 = cs.phase_e1(cs.phase_e1_setup(dev, tmp))
    say("phase E1 best %.3f ms" % (1e3 * e1["s_per_request"]))


def main():
    flags = ("--transforms", "--scan-kernels", "--chunk-kernels")
    only = [a for a in sys.argv[1:] if a in flags]
    args = [a for a in sys.argv[1:] if a not in flags]
    if len(args) > 1 and args[0] == "--one":
        one(args[1], only[0] if only else None)
        return
    for root in args:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root] + only[:1], check=True)


if __name__ == "__main__":
    main()
