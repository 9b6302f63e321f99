"""
A/B timing of copies of detex_torch on one CUDA card: for each tree given
(a directory holding a ``detex_torch/`` package, e.g. a ``git archive`` of
another commit), in the order given and each in a process of its own,
build its kernels and time fwd_prep_fold (CUDA events, mean of 5 after a
0.5 s warm-up) and the summary-only phase-A scan (host clock, best of 3
after a warm-up) at chip_smoke's phase-A shape: 256 two-hour chunks at
100 Hz on three channels, one 4-dim subspace of 30 s templates.

    python3 scripts/ab_torch_variants.py TREE_A TREE_B TREE_B TREE_A

Give the trees in turns (A, B, B, A) so that drift on the card shows.
"""
import os
import subprocess
import sys
import time

NC = 3
LC = 2160000            # two hours at 100 Hz on three channels
N = 9000                # 30 s templates


def one(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from detex_torch.kernels import build
    from detex_torch.ops import cuda_kernels as ck
    from detex_torch.ops import ds as tds
    from detex_torch.parallel import scan as tscan
    if not str(build.KERNEL_DIR).startswith(root):
        raise RuntimeError("imported %s, not the tree %s"
                           % (build.KERNEL_DIR, root))
    dev = torch.device("cuda")
    build.load_library()
    q, _ = np.linalg.qr(np.random.default_rng(1).standard_normal((N, 4)))
    bank = tds.build_bank([np.ascontiguousarray(q.T)], NC, LC, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((256, LC), generator=g, device=dev)
    n_c, blk = N // NC, bank["blk_fft"]
    xq, out_len = tds.standardize_demux(X, n_c, NC, blk)

    def prep():
        ck.fwd_prep_fold(xq, NC, n_c, blk, out_len)

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        prep()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        prep()
    end.record()
    torch.cuda.synchronize()
    prep_ms = start.elapsed_time(end) / 5
    del xq
    th = np.full(1, 0.5, np.float32)
    scan = []
    for _ in range(4):                              # first run warms up
        t0 = time.perf_counter()
        tscan.scan_chunks(X, bank, th, NC, 2000, max_trig=16,
                          calc_triggers=False)
        torch.cuda.synchronize()
        scan.append(1e3 * (time.perf_counter() - t0))
    print("%s: fwd_prep_fold %.3f ms; phase-A scan best %.3f ms %s"
          % (root, prep_ms, min(scan[1:]), [round(t, 3) for t in scan[1:]]),
          flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)


if __name__ == "__main__":
    main()
