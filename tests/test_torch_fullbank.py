"""detex_torch's full-length demuxed and multiplexed banks held against
detex_tpu on the CPU: build_bank's choice of form and block, the DS of one
chunk (ds_bank_demux through ds_finalize's twin, ds_bank), masked basis
slots and padded rows, a gapped chunk, the host and batch entry points,
the fixed-capacity trigger forms and scan_chunks' "plain" route on these
banks; and ds_finalize's twin against detex_tpu's Pallas kernel in
interpret mode.

Both packages see the same seeded numpy inputs and, through
bank_from_numpy, identical template spectra. Tolerances: DS and maxima
atol 2e-5 (tests/test_ds.py) with -inf positions identical, the float64
oracle ds_numpy within 2e-5, trigger indices and counts exact, histogram
row totals exact with at most 40 edge-ULP bin moves (floor rule against
np.histogram's), template spectra atol 2e-5 (the port transforms in
float64 on the host, detex_tpu in float32).
"""
import numpy as np
import pytest
import torch

from detex_tpu.ops import ds as jds
from detex_tpu.ops import pallas_kernels as jpk
from detex_tpu.ops import triggers as jtrig
from detex_tpu.parallel import scan as jscan
from detex_torch.ops import ds as tds
from detex_torch.ops import reference as ref
from detex_torch.ops import triggers as ttrig
from detex_torch.parallel import scan as tscan

NC = 3
N_C = 100
N = NC * N_C
L_C = 4000
LC = NC * L_C


def _U_list(rng, S, D, n=N):
    out = []
    for s in range(S):
        d = D if s % 2 == 0 else max(1, D - 1)      # ragged -> d_mask
        q, _ = np.linalg.qr(rng.standard_normal((d, n)).T)
        out.append(np.ascontiguousarray(q[:, :d].T))
    return out


def _as_np(bank):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in bank.items()}


def _banks(U_list, Lc=LC, **kw):
    jb = jds.build_bank(U_list, NC, Lc, **kw)
    return jb, tds.bank_from_numpy(_as_np(jb), "cpu")


def _chunk(rng, U, off, Lc=LC):
    x = rng.standard_normal(Lc).astype(np.float32)
    x[NC * off:NC * off + U.shape[1]] += 3.0 * np.sqrt(U.shape[1]) * U[0]
    return x


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(t, j, atol=2e-5):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    assert np.array_equal(np.isfinite(t), np.isfinite(j))
    fin = np.isfinite(j)
    if fin.any():
        assert np.abs(t[fin] - j[fin]).max() <= atol
    assert np.array_equal(t[~fin], j[~fin])


def _oracle_close(t, x, U):
    """The port's DS row against ds_numpy: within 2e-5 where the oracle
    has power, exactly 0 where it has none (its 0/0)."""
    o = tds.ds_numpy(x, U, NC)
    t = _np(t)
    assert t.shape == o.shape
    fin = np.isfinite(o)
    assert np.abs(t[fin] - o[fin]).max() <= 2e-5
    assert np.all(t[~fin] == 0.0)
    return o


def _kind(jb):
    return "os" if jb.get("os") else ("demux" if jb.get("demux") else "mux")


# name -> (template length, chunk length, build_bank keywords, spectra
# budget or None, the form both packages pick, or (the port's, detex_tpu's)
# where their defaults differ: prefer_os, ROADMAP C22)
BUILD_CASES = {
    "defaults": (N, LC, dict(), None, ("os", "demux")),
    "block0": (N, LC, dict(block_fft=0), None, "demux"),
    "pinned": (N, LC, dict(block_fft=2048), None, "os"),
    "mux": (N + 1, LC, dict(), None, "mux"),
    "short-chunk": (NC * 130, NC * 100, dict(prefer_os=True), None, "demux"),
    "under-budget": (N, LC, dict(prefer_os=False), None, "demux"),
    "over-budget": (N, LC, dict(prefer_os=False), 1000, "os"),
    "ladders": (N, LC, dict(prefer_os=False, pad_S=8, min_dmax=4), None,
                "demux"),
}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_bank_form_matches_jax(monkeypatch, case):
    """build_bank's form, block or FFT length, keys, shapes and statics
    equal detex_tpu's on a table of geometries (block_fft=0, a pinned
    block, a template length not a multiple of nc, a chunk too short for
    one overlap-save block, under and over the full-length spectra
    budget, the pad_rows / pad_dims ladders); spectra equal to float32
    rounding. With no keywords the port builds the overlap-save form and
    detex_tpu the full-length one (prefer_os defaults True and False); the
    port with prefer_os=False builds detex_tpu's form."""
    n, Lc, kw, budget, kind = BUILD_CASES[case]
    if budget is not None:
        monkeypatch.setattr(jds, "OS_SPECTRA_BUDGET", budget)
        monkeypatch.setattr(tds, "OS_SPECTRA_BUDGET", budget)
    U_list = _U_list(np.random.default_rng(n), 3, 2, n)
    jb = jds.build_bank(U_list, NC, Lc, **kw)
    tb = tds.build_bank(U_list, NC, Lc, "cpu", **kw)
    if isinstance(kind, tuple):
        assert (tds.bank_kind(tb), _kind(jb)) == kind
        assert tds.bank_kind(tds.build_bank(U_list, NC, Lc, "cpu",
                                            prefer_os=False)) == kind[1]
        return
    assert _kind(jb) == tds.bank_kind(tb) == kind
    assert set(jb) == set(tb)
    for k, v in jb.items():
        if hasattr(v, "shape"):
            assert tuple(tb[k].shape) == tuple(v.shape), k
        else:
            assert tb[k] == v, k
    spec = "Ufd" if kind == "mux" else "Ufd2"
    np.testing.assert_allclose(tb[spec].numpy(), np.asarray(jb[spec]),
                               rtol=0, atol=2e-5)
    assert np.array_equal(tb["d_mask"].numpy(), np.asarray(jb["d_mask"]))


@pytest.mark.parametrize("form", ["demux", "mux"])
def test_ds_matches_jax_and_oracle(form):
    """ds_bank_demux (ds_finalize's twin) and ds_bank against detex_tpu's
    namesakes and the float64 oracle on one chunk with a planted event;
    the batch forms equal a loop of the single-chunk ones."""
    rng = np.random.default_rng(11)
    n = N if form == "demux" else N + 1
    U_list = _U_list(rng, 3, 2, n)
    jb, tb = _banks(U_list, block_fft=0)
    x = _chunk(rng, U_list[2], 1500)
    if form == "demux":
        args = (tb["Ufd2"], tb["sum_u"], tb["d_mask"], N_C, NC, tb["nfft2"])
        t = tds.ds_bank_demux(torch.from_numpy(x), *args)
        j = jds.ds_bank_demux(x, jb["Ufd2"], jb["sum_u"], jb["d_mask"], N_C,
                              NC, jb["nfft2"])
        batch = tds.ds_bank_demux_chunks(torch.from_numpy(np.stack([x, x])),
                                         *args)
    else:
        args = (tb["Ufd"], tb["sum_u"], tb["d_mask"], n, NC, tb["nfft"])
        t = tds.ds_bank(torch.from_numpy(x), *args)
        j = jds.ds_bank(x, jb["Ufd"], jb["sum_u"], jb["d_mask"], n, NC,
                        jb["nfft"])
        batch = tds.ds_bank_chunks(torch.from_numpy(np.stack([x, x])), *args)
    assert tuple(t.shape) == (3, -(-(LC - n + 1) // NC))
    _close(t, j)
    assert torch.equal(batch[0], t) and torch.equal(batch[1], t)
    for s in range(3):
        _oracle_close(t[s], x, U_list[s])
    assert int(np.argmax(_np(t[2]))) == 1500


def test_ds_finalize_twin_matches_pallas_kernel():
    """ds_finalize_ref (the twin of B10) against detex_tpu's ds_finalize
    Pallas kernel in interpret mode and its XLA form: L not a multiple of
    the lane tile, power inf at a few positions (DS 0 there), a masked
    slot (cc row 0, sum_u 0)."""
    rng = np.random.default_rng(5)
    S, D, L = 3, 2, 1001
    cc = (rng.standard_normal((S, D, L)) * 4).astype(np.float32)
    cc[1, 1] = 0.0
    a = rng.standard_normal(L).astype(np.float32)
    pw = rng.uniform(20, 200, L).astype(np.float32)
    pw[7:11] = np.inf
    su = rng.standard_normal((S, D)).astype(np.float32)
    su[1, 1] = 0.0
    t = ref.ds_finalize_ref(*map(torch.from_numpy, (cc, a, pw, su)))
    for j in (jpk.ds_finalize(cc, a, pw, su, interpret=True),
              jpk.ds_finalize_xla(cc, a, pw, su)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    assert bool((t[:, 7:11] == 0).all())


@pytest.mark.parametrize("form", ["demux", "mux"])
def test_masked_slots_and_padded_rows(form):
    """Banks padded by the ladders (pad_S rows of zero templates, min_dmax
    masked basis slots): the padded rows' DS is identically 0 and the real
    rows equal the unpadded bank's (and detex_tpu's padded bank's)."""
    rng = np.random.default_rng(13)
    n = N if form == "demux" else N + 1
    U_list = _U_list(rng, 3, 2, n)
    x = _chunk(rng, U_list[0], 900)
    jb, tb = _banks(U_list, block_fft=0, pad_S=5, min_dmax=4)
    _, tb0 = _banks(U_list, block_fft=0)
    assert tuple(tb["sum_u"].shape) == (5, 4)
    assert torch.equal(tb["d_mask"][:3, :2], tb0["d_mask"])
    assert not bool(tb["d_mask"][:, 2:].any())
    t = tds.run_bank(x, tb, NC)
    _close(t[:3], tds.run_bank(x, tb0, NC), atol=1e-6)
    assert np.all(t[3:] == 0.0)
    _close(t, jds.run_bank(x, jb, NC))


@pytest.mark.parametrize("form", ["demux", "mux"])
def test_gapped_chunk_zero_power(form):
    """A chunk with a zero-filled gap longer than the template: the port
    gives DS exactly 0 at every window the float64 oracle finds without
    power and agrees with it within 2e-5 elsewhere, the windows that
    straddle the gap's edges included (the exact zero-power rule and the
    float64 sums of rolling.window_stats_rows, also on the multiplexed
    form, where detex_tpu keeps float32 rolling means and is off there:
    ROADMAP C23); detex_tpu agrees with the port on the windows that do
    not touch the gap."""
    rng = np.random.default_rng(17)
    n = N if form == "demux" else N + 1
    U_list = _U_list(rng, 2, 2, n)
    jb, tb = _banks(U_list, block_fft=0)
    x = _chunk(rng, U_list[1], 2800)
    g0, g1 = NC * 1000, NC * 1000 + 3 * n
    x[g0:g1] = 0.0
    t = tds.run_bank(x, tb, NC)
    j = np.asarray(jds.run_bank(x, jb, NC))
    start = np.arange(t.shape[1]) * NC
    away = (start + n <= g0) | (start >= g1)
    for s in range(2):
        o = _oracle_close(t[s], x, U_list[s])
        assert (~np.isfinite(o)).sum() >= 2 * n // NC
        assert np.abs(t[s][away] - j[s][away]).max() <= 2e-5


@pytest.mark.parametrize("form", ["demux", "mux"])
def test_host_and_batch_entries_match_jax(form):
    """run_bank, run_bank_rows and the batch entries (run_bank_batch,
    run_bank_rows_batch, run_bank_triggers_batch) on a full-length and a
    multiplexed bank: three chunks, one ragged, one with an event for row
    0 and one for row 1; against detex_tpu and the float64 oracle."""
    rng = np.random.default_rng(19)
    n = N if form == "demux" else N + 1
    U_list = _U_list(rng, 2, 2, n)
    jb, tb = _banks(U_list, block_fft=0)
    xs = [_chunk(rng, U_list[0], 700), _chunk(rng, U_list[1], 3000),
          rng.standard_normal(LC).astype(np.float32)]
    xs[1] = xs[1][:NC * (L_C - 500)]
    t = tds.run_bank(xs[1], tb, NC)
    _close(t, np.asarray(jds.run_bank(xs[1], jb, NC)))
    rows = tds.run_bank_rows(xs[1], tb, NC, [1, 0])
    rows_j = jds.run_bank_rows(xs[1], jb, NC, [1, 0])
    for s in (0, 1):
        _close(rows[s], rows_j[s])
        assert np.array_equal(rows[s], t[s])
        _oracle_close(rows[s], xs[1], U_list[s])
    got = tds.run_bank_batch(xs, tb, NC)
    want = jds.run_bank_batch(xs, jb, NC)
    rb = tds.run_bank_rows_batch(xs, tb, NC, [[0], [1, 0], []])
    for i in range(3):
        _close(got[i], want[i])
        for s, r in rb[i].items():
            assert np.array_equal(r, got[i][s])
    assert rb[2] == {}
    thr = [[0.5], [0.5], [0.5]]
    trig = tds.run_bank_triggers_batch(xs, tb, NC, [[0], [1], [0]], thr,
                                       [25.0] * 3, 10.0, 0.5, True)
    trig_j = jds.run_bank_triggers_batch(xs, jb, NC, [[0], [1], [0]], thr,
                                         [25.0] * 3, 10.0, 0.5, True)
    for i, s in ((0, 0), (1, 1), (2, 0)):
        assert np.array_equal(trig[i][s][0], trig_j[i][s][0])
        np.testing.assert_allclose(trig[i][s][1], trig_j[i][s][1], rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(trig[i][s][2], trig_j[i][s][2],
                                   rtol=1e-5)
    assert [len(trig[i][s][0]) for i, s in ((0, 0), (1, 1), (2, 0))] == [
        1, 1, 0]
    assert int(trig[0][0][0][0]) == 700 and int(trig[1][1][0][0]) == 3000


def _trigger_rows(rng, L):
    """Rows with the cases the extraction must get exactly: two equal
    maxima (ties), a plateau, maxima near both ends (the clamp), -inf pad
    positions, a row below threshold."""
    r = rng.uniform(0, 0.3, (5, L)).astype(np.float32)
    r[0, [L // 5, 4 * L // 5]] = 0.9
    r[1, L // 3:L // 3 + 40] = 0.8
    r[2, [3, L - 2]] = [0.95, 0.7]
    r[3, L // 2] = 0.99
    r[3, L - 100:] = -np.inf
    r[4] = np.minimum(r[4], 0.2)
    r[4, 17] = 0.25
    return r


@pytest.mark.parametrize("L", [3000, 5000])
def test_fixed_capacity_triggers_match_jax(L):
    """extract_triggers_topk and extract_triggers_pyramid (block 512, the
    pyramid built from the row) against detex_tpu's, row by row: ties to
    the first occurrence, plateaus, end clamps, -inf pads, rows shorter
    and longer than PYRAMID_MIN_LEN; indices and counts exact."""
    rng = np.random.default_rng(L)
    r = _trigger_rows(rng, L)
    thr = np.array([0.5, 0.5, 0.5, 0.5, 0.26], np.float32)
    rt = torch.from_numpy(r)
    th = torch.from_numpy(thr)
    tk = ttrig.extract_triggers_topk(rt, th, 250, max_triggers=6)
    tp = ttrig.extract_triggers_pyramid(rt, th, 250, max_triggers=6)
    for (idx, cnt) in (tk, tp):
        assert idx.dtype == cnt.dtype == torch.int32
        assert tuple(idx.shape) == (5, 6)
    assert torch.equal(tk[0], tp[0]) and torch.equal(tk[1], tp[1])
    for i in range(5):
        for fn in (jtrig.extract_triggers_topk,
                   jtrig.extract_triggers_pyramid):
            ji, jc = fn(r[i], thr[i], 250, max_triggers=6)
            assert np.array_equal(tk[0][i].numpy(), np.asarray(ji)), i
            assert int(tk[1][i]) == int(jc), i
    assert tk[0][0, :2].tolist() == [L // 5, 4 * L // 5]
    assert int(tk[1][4]) == 0


# case -> (form, L_c): row lengths 3901 / 3900 (< PYRAMID_MIN_LEN: the
# full-row form) and 5901 (the pyramid)
SCAN_CASES = {"demux": ("demux", L_C), "demux-long": ("demux", 6000),
              "mux": ("mux", L_C)}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
@pytest.mark.parametrize("calc_triggers", [True, False])
def test_scan_chunks_plain_route_matches_jax(case, calc_triggers):
    """scan_chunks on a full-length and a multiplexed bank takes route
    "plain" (detex_tpu's _os_fold_route falls through for these forms) and
    agrees with detex_tpu's scan: one planted event, one ragged chunk, one
    empty padded chunk."""
    form, L_c = SCAN_CASES[case]
    rng = np.random.default_rng(L_c + int(calc_triggers))
    n = N if form == "demux" else N + 1
    U_list = _U_list(rng, 3, 2, n)
    Lc = NC * L_c
    jb, tb = _banks(U_list, Lc, block_fft=0)
    X = np.stack([_chunk(rng, U_list[2], L_c // 3, Lc),
                  rng.standard_normal(Lc).astype(np.float32),
                  np.zeros(Lc, np.float32)])
    lens = [Lc, Lc - NC * 700, 0]
    X[1, lens[1]:] = 0.0
    th = np.full(3, 0.6, np.float32)
    kw = dict(max_trig=8, valid_lens=lens, calc_triggers=calc_triggers)
    tscan.ROUTE_COUNTS.clear()
    out_t = tscan.scan_chunks(X, tb, th, NC, 250, **kw)
    out_j = jscan.scan_chunks(X, dict(jb), th, NC, 250, **kw)
    assert dict(tscan.ROUTE_COUNTS) == {"plain": 1}
    h_t, m_t, ti_t, tv_t, tc_t = map(_np, out_t)
    h_j, m_j, ti_j, tv_j, tc_j = map(np.asarray, out_j)
    assert h_t.dtype == np.int32 and h_t.shape == h_j.shape
    assert np.array_equal(h_t.sum(-1), h_j.sum(-1))
    assert np.abs(h_t.astype(np.int64) - h_j).sum() <= 40
    _close(m_t, m_j)
    assert np.array_equal(ti_t, ti_j) and np.array_equal(tc_t, tc_j)
    o = tds.ds_numpy(X[0], U_list[2], NC)
    assert abs(np.nanmax(o) - m_t[0, 2]) <= 2e-5
    assert np.all(np.isneginf(m_t[2]))
    if calc_triggers:
        k = ti_j >= 0
        assert np.abs(tv_t[k] - tv_j[k]).max() <= 2e-5
        assert np.all(np.isnan(tv_t[~k]))
        assert int(tc_t[0, 2]) == 1 and int(ti_t[0, 2, 0]) == np.nanargmax(o)
    else:
        assert ti_t.shape == (3, 3, 0)
