"""detex_torch's sharded scans (parallel/mesh.py, scan_chunks_sharded,
scan_chunks_raw_sharded) held against detex_tpu's on the CPU.

detex_tpu shards over the 8 virtual CPU devices tests/conftest.py gives
it, with its Pallas switches on (interpret mode) for the overlap-save
banks and the block pinned on both sides (ROADMAP C1); the port shards
over a mesh of repeated CPU devices and runs its kernels' plain twins.
Both see the same seeded numpy inputs and, through bank_from_numpy,
identical template spectra. Batches include ones the mesh size does not
divide (5 on 8, 11 on 4), which both pad with zero-length chunks.

Against detex_tpu's sharded scan: the same route name (or ROADMAP C20's
pair), histogram row totals exact with at most 40 edge-ULP bin moves (the
rule every port scan test holds against detex_tpu: the floor rule on the
port's spectra against interpret-mode ones moves values at bin edges,
ROADMAP C2, C8; up to 22 moves here), maxima and trigger values within
1e-5 (detex_tpu's own sharded-scan tolerance) with -inf positions
identical, trigger counts and indices exact. Against the port's own unsharded scan of the same
batch: the histograms and the trigger counts and indices equal exactly,
the maxima and trigger values bit for bit where the per-shard route is
the whole batch's, and within 1e-6 where it is not.
"""
import numpy as np
import pytest
import torch

from detex_tpu.ops import ds as jds
from detex_tpu.parallel import mesh as jmesh
from detex_tpu.parallel import scan as jscan
from detex_torch.ops import ds as tds
from detex_torch.ops import prep as tprep
from detex_torch.parallel import mesh as tmesh
from detex_torch.parallel import scan as tscan

NC = 3
N = 1680                      # multiplexed template length (n_c = 560)
LC = 3 * 35000
BLK = 16384


@pytest.fixture()
def jax_fused_env(monkeypatch):
    monkeypatch.setenv("DETEX_TPU_PALLAS", "1")
    monkeypatch.setenv("DETEX_TPU_MATMUL_FFT", "1")
    yield


def _basis(rng, D, n):
    q, _ = np.linalg.qr(rng.standard_normal((n, D)))
    return np.ascontiguousarray(q[:, :D].T)


def _U_list(rng, S, D, n=N):
    return [_basis(rng, D if s % 2 == 0 else max(1, D - 1), n)
            for s in range(S)]


def _as_np(bank):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in bank.items()}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cpu_mesh(n):
    return tmesh.make_mesh(devices=["cpu"] * n)


def _check_against_jax(out_t, out_j):
    h_t, m_t, ti_t, tv_t, tc_t = map(_np, out_t)
    h_j, m_j, ti_j, tv_j, tc_j = map(np.asarray, out_j)
    assert h_t.shape == h_j.shape and h_t.dtype == np.int32
    assert np.array_equal(h_t.sum(-1), h_j.sum(-1))
    assert np.abs(h_t.astype(np.int64) - h_j).sum() <= 40
    assert m_t.shape == m_j.shape
    assert np.array_equal(np.isfinite(m_t), np.isfinite(m_j))
    fin = np.isfinite(m_j)
    assert np.abs(m_t[fin] - m_j[fin]).max(initial=0.0) <= 1e-5
    assert np.array_equal(tc_t, tc_j)
    K = min(ti_t.shape[-1], ti_j.shape[-1])
    assert np.array_equal(ti_t[..., :K], ti_j[..., :K])
    k = ti_j[..., :K] >= 0
    assert np.abs(tv_t[..., :K][k] - tv_j[..., :K][k]).max(
        initial=0.0) <= 1e-5


def _unsharded(fn):
    """fn()'s scan outputs and the route it took."""
    tscan.ROUTE_COUNTS.clear()
    out = fn()
    (route,) = _routes(tscan.ROUTE_COUNTS)
    return out, route


def _check_against_unsharded(out_s, out_1, route_s, route_1):
    bitwise = route_s.replace("+sharded", "") == route_1
    h_s, m_s, ti_s, tv_s, tc_s = map(_np, out_s)
    h_1, m_1, ti_1, tv_1, tc_1 = map(_np, out_1)
    assert np.array_equal(h_s, h_1)
    assert np.array_equal(tc_s, tc_1) and np.array_equal(ti_s, ti_1)
    if bitwise:
        assert np.array_equal(m_s, m_1)
        assert np.array_equal(tv_s, tv_1, equal_nan=True)
    else:
        assert np.array_equal(np.isfinite(m_s), np.isfinite(m_1))
        fin = np.isfinite(m_1)
        assert np.abs(m_s[fin] - m_1[fin]).max(initial=0.0) <= 1e-6
        k = ti_1 >= 0
        assert np.abs(tv_s[k] - tv_1[k]).max(initial=0.0) <= 1e-6


def _routes(counts):
    return sorted(counts)


def _same_route(route_t, route_j):
    """The port's route name is detex_tpu's, or the pair ROADMAP C20
    lists: fused mode "sub" where detex_tpu's VMEM tile budget sends the
    batch to its unfused "fold" route."""
    if route_t == route_j:
        return True
    head, _, tail = route_t.partition("+sharded")
    return (head.startswith("fused-sub")
            and route_j == "fold+sharded" + tail)


def _clear_routes():
    tscan.ROUTE_COUNTS.clear()
    jscan.ROUTE_COUNTS.clear()


def test_mesh_helpers():
    """make_mesh's size, axis and device normalisation; shard_chunks'
    row ranges; replicated returns the bank itself on its own device,
    and engine_mesh is None without several CUDA devices or with
    DETEX_TORCH_MESH=0."""
    mesh = _cpu_mesh(4)
    assert mesh.size == 4 and mesh.axis == "chunks"
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert tmesh.make_mesh(2, devices=["cpu"] * 8).size == 2
    assert tmesh.shard_chunks(mesh, 8) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError):
        tmesh.shard_chunks(mesh, 6)
    bank = tds.build_bank([_basis(np.random.default_rng(1), 1, N)], NC, LC,
                          "cpu", block_fft=BLK)
    assert all(b is bank for b in tmesh.replicated(mesh, bank))
    assert tscan.engine_mesh("cpu") is None
    assert tscan.engine_mesh() is None          # no card here
    X = np.ones((5, 4), np.float32)
    Xp, nvp, B = tscan._pad_batch(4, X, np.arange(5, dtype=np.int32))
    assert B == 5 and Xp.shape == (8, 4) and not Xp[5:].any()
    assert nvp.tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    Xt, _, _ = tscan._pad_batch(4, torch.ones(5, 4), np.zeros(5, np.int32))
    assert Xt.shape == (8, 4) and float(Xt[5:].abs().sum()) == 0.0


def test_engine_mesh_switch(monkeypatch):
    """engine_mesh: every CUDA device when there are several (faked here),
    none for a CPU engine or with DETEX_TORCH_MESH=0."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("DETEX_TORCH_MESH", raising=False)
    assert tscan.engine_mesh("cpu") is None
    mesh = tscan.engine_mesh("cuda")
    assert mesh.size == 4 and [str(d) for d in mesh] == [
        "cuda:%d" % i for i in range(4)]
    monkeypatch.setenv("DETEX_TORCH_MESH", "0")
    assert tscan.engine_mesh("cuda") is None


def test_run_shards_one_thread_per_card(monkeypatch):
    """_run_shards runs the shards of each distinct CUDA device in order in
    one host thread of their own, the cards' threads at once (two fake
    cards here, three shards each, whose first shards meet at a barrier;
    the library build asked for once beforehand), the shards of a CPU mesh
    in the calling thread, and returns the results in mesh order."""
    import collections
    import threading
    Card = collections.namedtuple("Card", "type index")
    cards = [Card("cuda", i % 2) for i in range(6)]
    built = []
    monkeypatch.setattr(tscan._build, "load_library",
                        lambda: built.append(1))
    seen = []
    meet = threading.Barrier(2, timeout=60)

    def body(i, r0, r1):
        seen.append((cards[i].index, i, threading.get_ident()))
        if i < 2 and isinstance(cards[0], Card):
            meet.wait()              # both cards' threads are running
        return (i, r0, r1)

    out = tscan._run_shards(cards, 12, body)
    assert out == [(i, 2 * i, 2 * i + 2) for i in range(6)]
    assert built == [1]
    by_card = collections.defaultdict(list)
    for card, i, tid in seen:
        by_card[card].append((i, tid))
    assert [i for i, _ in by_card[0]] == [0, 2, 4]
    assert [i for i, _ in by_card[1]] == [1, 3, 5]
    tids = {card: {t for _, t in v} for card, v in by_card.items()}
    assert all(len(t) == 1 for t in tids.values())
    assert tids[0] != tids[1] and threading.get_ident() not in \
        tids[0] | tids[1]
    seen.clear()
    cards = _cpu_mesh(3)
    assert tscan._run_shards(cards, 3, body) == [
        (0, 0, 1), (1, 1, 2), (2, 2, 3)]
    assert {t for _, _, t in seen} == {threading.get_ident()}


def test_launch_counts_from_many_threads():
    """The kernels' launch counts lose no update when the cards' threads
    count at once: 16 threads add 2,000 launches each with a short switch
    interval."""
    import sys
    import threading
    from detex_torch.ops import cuda_kernels as tck
    saved = dict(tck.LAUNCHES)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tck.reset_launches()
        threads = [threading.Thread(target=lambda: [
            tck._count("spec_ds_fold") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert tck.LAUNCHES["spec_ds_fold"] == 16 * 2000
    finally:
        sys.setswitchinterval(interval)
        tck.LAUNCHES.update(saved)


@pytest.mark.parametrize("B", [8, 5])
def test_sharded_demux_bank_matches_jax(B):
    """scan_chunks on a full-length demuxed bank (tests/test_sharding.py's
    small bank) over an 8-entry mesh: route "plain+sharded"."""
    n, D = 510, 2
    rng = np.random.default_rng(0)
    U = _basis(rng, D, n)
    jb = jds.build_bank([U], NC, 3 * (1 << 12))
    assert jb.get("demux") and not jb.get("os")
    tb = tds.bank_from_numpy(_as_np(jb), "cpu")
    X = np.random.default_rng(5 + B).standard_normal(
        (B, jb["pad_len"])).astype(np.float32)
    X[1, 300:300 + n] += 40.0 * U[0]
    th = np.full(1, 0.45, np.float32)
    _clear_routes()
    out_j = jscan.scan_chunks_sharded(jmesh.make_mesh(8), X, jb, th, NC,
                                      buff_samps=100, max_trig=8)
    out_t = tscan.scan_chunks(X, tb, th, NC, 100, max_trig=8,
                              mesh=_cpu_mesh(8))
    assert _routes(tscan.ROUTE_COUNTS) == _routes(jscan.ROUTE_COUNTS) == [
        "plain+sharded"]
    _check_against_jax(out_t, out_j)
    assert int(_np(out_t[4])[1, 0]) >= 1
    out_1, route_1 = _unsharded(lambda: tscan.scan_chunks(
        X, tb, th, NC, 100, max_trig=8))
    _check_against_unsharded(out_t, out_1, "plain+sharded", route_1)


@pytest.mark.parametrize("B, n_dev, S, calc_triggers", [
    (13, 4, 8, True), (5, 8, 3, False)])
def test_sharded_os_bank_matches_jax(jax_fused_env, B, n_dev, S,
                                     calc_triggers):
    """scan_chunks on an overlap-save bank (the fused route, its mode
    chosen on the per-shard batch) over 4 and 8 entries, with triggers and
    summary-only: 13 chunks of 8 templates in shards of 4 (mode "net" in
    both packages; the unsharded batch of 13 takes mode "sub"), and 5
    chunks of 3 in shards of 1 (mode "sub", where detex_tpu takes "fold":
    ROADMAP C20)."""
    rng = np.random.default_rng(20 + B)
    U_list = _U_list(rng, S, 2)
    jb = jds.build_bank(U_list, NC, LC, prefer_os=True, block_fft=BLK)
    tb = tds.bank_from_numpy(_as_np(jb), "cpu")
    X = rng.standard_normal((B, LC)).astype(np.float32)
    X[B - 2, 3 * 4000:3 * 4000 + N] += 60.0 * U_list[1][0]
    th = np.full(S, 0.4, np.float32)
    kw = dict(max_trig=8, calc_triggers=calc_triggers)
    _clear_routes()
    out_j = jscan.scan_chunks_sharded(jmesh.make_mesh(n_dev), X, jb, th, NC,
                                      buff_samps=250, **kw)
    out_t = tscan.scan_chunks(X, tb, th, NC, 250, mesh=_cpu_mesh(n_dev),
                              **kw)
    (route,) = _routes(tscan.ROUTE_COUNTS)
    (route_j,) = _routes(jscan.ROUTE_COUNTS)
    assert _same_route(route, route_j)
    assert route.startswith("fused-") and route.endswith("+sharded")
    _check_against_jax(out_t, out_j)
    out_1, route_1 = _unsharded(lambda: tscan.scan_chunks(
        X, tb, th, NC, 250, **kw))
    _check_against_unsharded(out_t, out_1, route, route_1)
    assert float(_np(out_t[1])[B - 2, 1]) > 0.5


def test_sharded_blocked_bank_matches_jax(jax_fused_env):
    """scan_chunks past 128 templates (route "blocked-fused-net+fusedprep"
    per shard) over 2 entries, 3 chunks (tests/test_torch_blocked.py's
    scale)."""
    S = 129
    rng = np.random.default_rng(31)
    U_list = _U_list(rng, S, 1)
    jb = jds.build_bank(U_list, NC, LC, prefer_os=True, block_fft=BLK)
    tb = tds.bank_from_numpy(_as_np(jb), "cpu")
    X = rng.standard_normal((3, LC)).astype(np.float32)
    X[2, 3 * 9000:3 * 9000 + N] += 60.0 * U_list[128][0]
    th = np.full(S, 0.4, np.float32)
    _clear_routes()
    out_j = jscan.scan_chunks_sharded(jmesh.make_mesh(2), X, jb, th, NC,
                                      buff_samps=250, max_trig=4)
    out_t = tscan.scan_chunks(X, tb, th, NC, 250, max_trig=4,
                              mesh=_cpu_mesh(2))
    assert _routes(tscan.ROUTE_COUNTS) == _routes(jscan.ROUTE_COUNTS) == [
        "blocked-fused-net+fusedprep+sharded"]
    _check_against_jax(out_t, out_j)
    assert int(_np(out_t[4])[2, 128]) == 1
    out_1, route_1 = _unsharded(lambda: tscan.scan_chunks(
        X, tb, th, NC, 250, max_trig=4))
    _check_against_unsharded(out_t, out_1,
                             "blocked-fused-net+fusedprep+sharded", route_1)


SR = 25.0                      # decimated rate of the raw cases
L_RAW = 6000
N_C = 100
FILT = [1.0, 8.0, 2, True]


def _raw_case(form, seed):
    """Five raw chunks [5, 3, L_RAW] at decimate 2 (one ragged, one empty),
    the event template cut from the float64 oracle's prepped chunk 0, and
    the bank of ``form`` ("os": overlap-save at blk 2048, "demux":
    full-length) of 3 templates; detex_tpu's bank, the port's, H."""
    dec = 2
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((5, NC, L_RAW)) + 2.0
    X += np.linspace(0.0, 10.0, L_RAW)[None, None, :]
    wav = np.convolve(rng.standard_normal(300), np.hanning(30), "same")
    X[0, :, 2500:2800] += 6.0 * wav
    X = X.astype(np.float32)
    lens = [L_RAW, L_RAW, L_RAW - 1500, 0, L_RAW]
    X[2, :, lens[2]:] = 0.0
    X[3] = 0.0
    jb0 = jds.build_bank([np.ones((1, NC * N_C))], NC, L_RAW // dec * NC,
                         block_fft=0)
    nfftp = jb0["nfft2"]
    H = tprep.butter_response(FILT, SR * dec, dec * nfftp, device="cpu")
    x0 = tprep.prep_numpy(X[0], lens[0], H.numpy(), nfftp, dec, NC)
    off = NC * (2500 // dec - N_C // 4)
    u = x0[off:off + NC * N_C]
    U_list = [(u / np.linalg.norm(u))[None, :]] + [
        _basis(rng, 2, NC * N_C) for _ in range(2)]
    kw = dict(block_fft=2048) if form == "os" else dict(block_fft=0)
    jb = jds.build_bank(U_list, NC, L_RAW // dec * NC, **kw)
    return X, lens, H, jb, tds.bank_from_numpy(_as_np(jb), "cpu")


@pytest.mark.parametrize("form", ["os", "demux"])
def test_sharded_raw_scan_matches_jax(monkeypatch, form):
    """scan_chunks_raw over a 4-entry mesh at decimate 2: on an
    overlap-save bank prep_multiplex_batch inside each shard, then the
    route picked for the shard; on a full-length bank "raw-demux" a
    chunk. Five chunks: one ragged, one empty, padded to eight."""
    monkeypatch.setenv("DETEX_TPU_PALLAS", "1")
    X, lens, H, jb, tb = _raw_case(form, 40 + len(form))
    th = np.full(3, 0.5, np.float32)
    kw = dict(max_trig=4, dec=2)
    _clear_routes()
    out_j = jscan.scan_chunks_raw_sharded(jmesh.make_mesh(4), X, lens,
                                          H.numpy(), jb, th, NC, 250, **kw)
    out_t = tscan.scan_chunks_raw(X, lens, H, tb, th, NC, 250,
                                  mesh=_cpu_mesh(4), **kw)
    (route,) = _routes(tscan.ROUTE_COUNTS)
    (route_j,) = _routes(jscan.ROUTE_COUNTS)
    assert _same_route(route, route_j)
    assert route.endswith("+sharded+devicePrep")
    assert route.startswith("raw-demux" if form == "demux" else "fold")
    _check_against_jax(out_t, out_j)
    assert int(_np(out_t[4])[0, 0]) == 1
    assert np.all(np.isneginf(_np(out_t[1])[3]))
    out_1, route_1 = _unsharded(lambda: tscan.scan_chunks_raw(
        X, lens, H, tb, th, NC, 250, **kw))
    _check_against_unsharded(out_t, out_1, route.replace(
        "+sharded+devicePrep", "+sharded"), route_1.replace(
            "+devicePrep", ""))


@pytest.mark.parametrize("case", ["mesh", "mux"])
def test_former_mesh_refusals_scan(case):
    """The inputs with which scan_chunks and scan_chunks_raw refused any
    mesh before the sharded scans were ported: an overlap-save bank's
    sharded scan of two chunks now equals the unsharded scan, and the raw
    scan of a multiplexed bank raises ValueError on a mesh as without
    one, as detex_tpu's does."""
    X = np.zeros((2, LC), np.float32)
    X[1] = np.random.default_rng(3).standard_normal(LC)
    kw = dict(buff_samps=250, max_trig=4)
    if case == "mesh":
        bank = tds.build_bank(_U_list(np.random.default_rng(5), S=3, D=1),
                              NC, LC, "cpu", block_fft=BLK)
        tscan.ROUTE_COUNTS.clear()
        out = tscan.scan_chunks(X, bank, np.ones(3), NC, mesh=_cpu_mesh(2),
                                **kw)
        (route,) = _routes(tscan.ROUTE_COUNTS)
        out_1, route_1 = _unsharded(lambda: tscan.scan_chunks(
            X, bank, np.ones(3), NC, **kw))
        _check_against_unsharded(out, out_1, route, route_1)
        return
    bank = tds.build_bank([np.ones((1, N + 1))], NC, LC, "cpu")
    assert tds.bank_kind(bank) == "mux"
    for mesh in (None, _cpu_mesh(2)):
        with pytest.raises(ValueError, match="demuxed bank"):
            tscan.scan_chunks_raw(X.reshape(2, NC, -1), [LC // NC] * 2,
                                  torch.ones(LC // NC + 1), bank, np.ones(1),
                                  NC, mesh=mesh, **kw)
