"""
A/B timing of copies of detex_torch on one CUDA card: for each tree given
(a directory holding a ``detex_torch/`` package and ``chip_smoke.py``, e.g.
a ``git archive`` of another commit), in the order given and each in a
process of its own, build its kernels and time

  - fwd_prep_fold and the summary-only phase-A scan at chip_smoke's phase-A
    shape (256 two-hour chunks at 100 Hz on three channels, one 4-dim
    subspace of 30 s templates);
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
  - the tree's own chip_smoke phases C (scan + dense re-verify) and D3
    (the fused scan behind the unfused prep).

Kernels by CUDA events (mean of ``reps`` launches after a 0.5 s warm-up);
shapes under one wave of the card (fewer rows than SMs), where the host's
launch rate and not the kernel would be timed, by CUDA events around the
replay of a CUDA graph of 50 launches; phases by the host clock (best of 3
or 2 after a warm-up). irfft_ct_fused at the re-verify's 1,728 rows is
timed as a control that shares nothing with the forward transforms.

    python3 scripts/ab_torch_variants.py [--transforms] \\
        TREE_A TREE_B TREE_B TREE_A

``--transforms`` times the forward block transforms only. Give the trees in
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
    spec = torch.randn((1728, 8193, 2), generator=g, device=dev)
    spec = torch.view_as_complex(spec)
    say("irfft_ct_fused 1728 x 16384 (control): %.4f ms"
        % cuda_ms(torch, lambda: ck.irfft_ct_fused(spec, 16384), 20))
    del spec
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


def one(root, transforms_only):
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
    build.load_library()
    transforms(torch, ck, dft, tds, dev, say)
    if transforms_only:
        return
    q, _ = np.linalg.qr(np.random.default_rng(1).standard_normal((N, 4)))
    bank = tds.build_bank([np.ascontiguousarray(q.T)], NC, LC, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((256, LC), generator=g, device=dev)
    n_c, blk = N // NC, bank["blk_fft"]
    xq, out_len = tds.standardize_demux(X, n_c, NC, blk)
    prep_ms = cuda_ms(torch, lambda: ck.fwd_prep_fold(xq, NC, n_c, blk,
                                                      out_len), 5)
    del xq
    th = np.full(1, 0.5, np.float32)
    scan = []
    for _ in range(4):                              # first run warms up
        t0 = time.perf_counter()
        tscan.scan_chunks(X, bank, th, NC, 2000, max_trig=16,
                          calc_triggers=False)
        torch.cuda.synchronize()
        scan.append(1e3 * (time.perf_counter() - t0))
    say("fwd_prep_fold %.3f ms; phase-A scan best %.3f ms %s"
        % (prep_ms, min(scan[1:]), [round(t, 3) for t in scan[1:]]))
    del X, bank
    torch.cuda.empty_cache()
    pc = cs.phase_c(dev, 256 * 2.0 / 24.0 / (min(scan[1:]) * 1e-3))
    say("phase C best %.3f ms" % (1e3 * pc["s_per_batch"]))
    del pc
    torch.cuda.empty_cache()
    d3 = cs.phase_d3(dev, cs.phase_d3_setup(dev))
    say("phase D3 best %.3f ms" % (1e3 * d3["s_per_launch"]))


def main():
    args = [a for a in sys.argv[1:] if a != "--transforms"]
    only = len(args) < len(sys.argv) - 1
    if len(args) > 1 and args[0] == "--one":
        one(args[1], only)
        return
    for root in args:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root] + ["--transforms"] * only, check=True)


if __name__ == "__main__":
    main()
