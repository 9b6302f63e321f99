"""detex_torch's device preprocessing (ops/prep.py) and the scans built on
it, held against detex_tpu on the CPU and against float64 oracles: the
filter response, the masked detrend, prep_multiplex_batch, the DS of a raw
chunk on a full-length bank (ds_bank_demux_raw through ds_finalize's twin,
run_bank_raw), scan_chunks_raw on overlap-save and full-length banks and
serving.scan_station_raw.

Both packages see the same seeded numpy inputs and, through
bank_from_numpy, identical template spectra; detex_tpu runs its Pallas
ds_finalize in interpret mode (DETEX_TPU_PALLAS=1). The float64 oracle is
prep.prep_numpy (the same detrend, rfft, response, truncation and irfft in
numpy) followed by ds_numpy; templates are cut from its prepped chunk at a
planted event. Tolerances: the response within 1e-7; prepped samples
within 1e-4 of the float64 oracle and of detex_tpu (float32 transforms of
unit-variance data); DS within 2e-5 of detex_tpu and of the oracle; the
host-filtered path within tests/test_device_prep.py's 5e-3 in the chunk
interior; scans with exact histogram row totals and at most 40 edge-ULP
bin moves, maxima within 2e-5, trigger indices exact.
"""
import json

import numpy as np
import pytest
import torch

from detex_tpu import serving as jserving
from detex_tpu.construct import _applyFilter, multiplex
from detex_tpu.core.stream import Stats, Stream, Trace
from detex_tpu.core.utc import UTCDateTime
from detex_tpu.ops import ds as jds
from detex_tpu.ops import prep as jprep
from detex_tpu.parallel import scan as jscan
from detex_torch import serving as tserving
from detex_torch.ops import ds as tds
from detex_torch.ops import prep as tprep
from detex_torch.parallel import scan as tscan

NC = 3
SR = 25.0                      # the decimated (template) rate
L_RAW = 6000
N_C = 100
FILT = [1.0, 8.0, 2, True]


@pytest.fixture()
def jax_pallas(monkeypatch):
    monkeypatch.setenv("DETEX_TPU_PALLAS", "1")
    yield


def _as_np(bank):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in bank.items()}


def _raw(rng, B, events):
    """B raw chunks [B, nc, L_RAW] of noise plus a trend and an offset,
    with band-limited events at (chunk, raw sample) ``events``."""
    X = rng.standard_normal((B, NC, L_RAW)) + 2.0
    X += np.linspace(0.0, 10.0, L_RAW)[None, None, :]
    for b, p in events:
        wav = np.convolve(rng.standard_normal(300), np.hanning(30), "same")
        X[b, :, p:p + 300] += 6.0 * wav
    return X.astype(np.float32)


def _templates(X, lens, events, H, nfftp, dec, S, D=2, seed=0):
    """One unit template per event, cut from the float64 oracle's prepped
    chunk n_c samples before the event, plus random D-dim bases up to S
    rows. Returns (U_list, prepped chunks [B, L_c*nc] float64)."""
    rng = np.random.default_rng(seed)
    Hn = H.numpy()
    xs = np.stack([tprep.prep_numpy(X[b], lens[b], Hn, nfftp, dec, NC)
                   for b in range(len(X))])
    n = NC * N_C
    U_list = []
    for b, p in events:
        off = NC * (p // dec - N_C // 4)
        u = xs[b, off:off + n]
        U_list.append((u / np.linalg.norm(u))[None, :])
    while len(U_list) < S:
        q, _ = np.linalg.qr(rng.standard_normal((n, D)))
        U_list.append(np.ascontiguousarray(q.T))
    return U_list, xs


@pytest.mark.parametrize("zerophase", [True, False])
def test_butter_response_matches_jax(zerophase):
    """|H|^2 (float32) and the complex one-pass H (complex64) equal
    detex_tpu's within 1e-7."""
    t = tprep.butter_response(FILT, 50.0, 16384, zerophase=zerophase,
                              device="cpu")
    j = np.asarray(jprep.butter_response(FILT, 50.0, 16384,
                                         zerophase=zerophase))
    assert t.dtype == (torch.float32 if zerophase else torch.complex64)
    assert tuple(t.shape) == j.shape == (8193,)
    assert np.abs(t.numpy() - j).max() <= 1e-7


def test_masked_detrend_matches_jax_and_float64():
    """_masked_detrend of a batch with one ragged chunk against a float64
    least-squares fit on the valid samples (within 1e-5) and detex_tpu's
    float32 fit (within 1e-3); the pad is zero."""
    rng = np.random.default_rng(3)
    X = _raw(rng, 2, [])
    lens = [L_RAW, 4000]
    X[1, :, 4000:] = 0.0
    t = tprep._masked_detrend(torch.from_numpy(X), lens).numpy()
    for b, Lv in enumerate(lens):
        i = np.arange(Lv, dtype=np.float64)
        for c in range(NC):
            coef = np.polyfit(i, X[b, c, :Lv].astype(np.float64), 1)
            want = X[b, c, :Lv] - np.polyval(coef, i)
            assert np.abs(t[b, c, :Lv] - want).max() <= 1e-5
        assert np.all(t[b, :, Lv:] == 0.0)
        j = np.asarray(jprep._masked_detrend(X[b], Lv))
        assert np.abs(t[b] - j).max() <= 1e-3


@pytest.mark.parametrize("dec", [1, 2])
def test_prep_multiplex_batch_matches_jax_and_oracle(dec):
    """prep_multiplex_batch at dec 1 and 2 on a batch with a ragged chunk:
    the multiplexed filtered chunks against detex_tpu's and prep_numpy's,
    the pad zeroed, the valid multiplexed lengths equal."""
    rng = np.random.default_rng(dec)
    X = _raw(rng, 2, [(0, 2000)])
    lens = [L_RAW, L_RAW - 1000]
    X[1, :, lens[1]:] = 0.0
    nfftp = tds.required_fft_len(L_RAW // dec, N_C)
    H = tprep.butter_response(FILT, SR * dec, dec * nfftp, device="cpu")
    Xt, lt = tprep.prep_multiplex_batch(torch.from_numpy(X), lens, H, nfftp,
                                        dec, NC)
    Xj, lj = jprep.prep_multiplex_batch(X, np.asarray(lens, np.int32),
                                        H.numpy(), nfftp, dec, NC)
    assert lt == [v // dec * NC for v in lens] == list(np.asarray(lj))
    assert tuple(Xt.shape) == (2, L_RAW // dec * NC)
    assert np.abs(Xt.numpy() - np.asarray(Xj)).max() <= 1e-4
    for b in range(2):
        o = tprep.prep_numpy(X[b], lens[b], H.numpy(), nfftp, dec, NC)
        assert np.abs(Xt[b].numpy() - o).max() <= 1e-4
        assert np.all(Xt[b, lt[b]:].numpy() == 0.0)


# case -> (dec, zero phase)
RAW_CASES = {"dec1": (1, True), "dec2": (2, True), "dec2-complex": (2, False)}


@pytest.mark.parametrize("case", sorted(RAW_CASES))
def test_run_bank_raw_matches_jax_and_oracles(jax_pallas, case):
    """run_bank_raw / ds_bank_demux_raw on a full-length bank, on a whole
    and on a ragged raw chunk: DS within 2e-5 of detex_tpu (its ds_finalize
    Pallas kernel in interpret mode) and of the float64 oracle, the planted
    event at the oracle's argmax; at dec 1 also within 5e-3 of the
    host-filtered path (detex_tpu's SOS bandpass and multiplex, then
    run_bank) in the chunk interior."""
    dec, zp = RAW_CASES[case]
    rng = np.random.default_rng(dec + 10 * zp)
    X = _raw(rng, 1, [(0, 3000)])
    filt = FILT[:3] + [zp]
    jb0 = jds.build_bank([np.ones((1, NC * N_C))], NC, L_RAW // dec * NC,
                         block_fft=0)
    H = tprep.butter_response(filt, SR * dec, dec * jb0["nfft2"], zp,
                              device="cpu")
    U_list, xs = _templates(X, [L_RAW], [(0, 3000)], H, jb0["nfft2"], dec,
                            S=3)
    jb = jds.build_bank(U_list, NC, L_RAW // dec * NC, block_fft=0)
    tb = tds.bank_from_numpy(_as_np(jb), "cpu")
    Hj = jprep.butter_response(filt, SR * dec, dec * jb["nfft2"], zp)
    for Lv in (L_RAW, L_RAW - 1300):
        chans = X[0, :, :Lv]
        t = tprep.run_bank_raw(chans, tb, NC, H, dec)
        j = np.asarray(jprep.run_bank_raw(chans, jb, NC, Hj, dec))
        assert t.shape == j.shape == (3, Lv // dec - N_C + 1)
        assert np.abs(t - j).max() <= 2e-5
        x64 = tprep.prep_numpy(np.pad(chans, ((0, 0), (0, L_RAW - Lv))), Lv,
                               H.numpy(), jb["nfft2"], dec, NC)
        for s in range(3):
            o = tds.ds_numpy(x64[:Lv // dec * NC], U_list[s], NC)
            assert np.abs(t[s] - o).max() <= 2e-5
        assert int(np.argmax(t[0])) == int(np.argmax(
            tds.ds_numpy(x64[:Lv // dec * NC], U_list[0], NC)))
    if dec == 1 and zp:
        st = Stream([Trace(X[0, c].astype(np.float64), Stats(dict(
            network="TA", station="S", channel="BH" + "ENZ"[c],
            sampling_rate=SR, starttime=UTCDateTime(0.0))))
            for c in range(NC)])
        host = multiplex(_applyFilter(st, FILT), NC)
        want = tds.run_bank(host, tb, NC)
        got = tprep.run_bank_raw(X[0], tb, NC, H, dec)
        edge = int(20 * SR)
        assert np.abs(got[:, edge:-edge] - want[:, edge:-edge]).max() < 5e-3


def _check_scan(out_t, out_j):
    h_t, m_t, ti_t, tv_t, tc_t = (np.asarray(o.numpy() if isinstance(
        o, torch.Tensor) else o) for o in out_t)
    h_j, m_j, ti_j, tv_j, tc_j = map(np.asarray, out_j)
    assert h_t.shape == h_j.shape
    assert np.array_equal(h_t.sum(-1), h_j.sum(-1))
    assert np.abs(h_t.astype(np.int64) - h_j).sum() <= 40
    assert np.array_equal(np.isfinite(m_t), np.isfinite(m_j))
    fin = np.isfinite(m_j)
    assert np.abs(m_t[fin] - m_j[fin]).max() <= 2e-5
    assert np.array_equal(ti_t, ti_j) and np.array_equal(tc_t, tc_j)
    k = ti_j >= 0
    assert k.any() and np.abs(tv_t[k] - tv_j[k]).max() <= 2e-5
    return m_t, ti_t, tc_t


@pytest.mark.parametrize("form", ["os", "demux"])
def test_scan_chunks_raw_matches_jax(jax_pallas, form):
    """scan_chunks_raw at dec 2 on an overlap-save bank (prep_multiplex_batch
    then scan_chunks: route "fold+devicePrep" at this block) and on a
    full-length bank (route "raw-demux+devicePrep"): three chunks, one
    ragged, one empty; against detex_tpu's scan_chunks_raw and the float64
    oracle at the planted event."""
    dec = 2
    rng = np.random.default_rng(40 + len(form))
    X = _raw(rng, 3, [(0, 2500)])
    lens = [L_RAW, L_RAW - 1500, 0]
    X[1, :, lens[1]:] = 0.0
    X[2] = 0.0
    jb0 = jds.build_bank([np.ones((1, NC * N_C))], NC, L_RAW // dec * NC,
                         block_fft=0)
    H = tprep.butter_response(FILT, SR * dec, dec * jb0["nfft2"],
                              device="cpu")
    U_list, xs = _templates(X, lens, [(0, 2500)], H, jb0["nfft2"], dec, S=3)
    kw = dict(block_fft=2048) if form == "os" else dict(block_fft=0)
    jb = jds.build_bank(U_list, NC, L_RAW // dec * NC, **kw)
    tb = tds.bank_from_numpy(_as_np(jb), "cpu")
    th = np.full(3, 0.5, np.float32)
    tscan.ROUTE_COUNTS.clear()
    out_t = tscan.scan_chunks_raw(X, lens, H, tb, th, NC, 250, max_trig=4,
                                  dec=dec)
    out_j = jscan.scan_chunks_raw(X, lens, H.numpy(), jb, th, NC, 250,
                                  max_trig=4, dec=dec)
    route = ("fold" if form == "os" else "raw-demux") + "+devicePrep"
    assert dict(tscan.ROUTE_COUNTS) == {route: 1}
    m_t, ti_t, tc_t = _check_scan(out_t, out_j)
    o = tds.ds_numpy(xs[0], U_list[0], NC)
    assert abs(float(m_t[0, 0]) - float(np.nanmax(o))) <= 2e-5
    assert int(tc_t[0, 0]) == 1 and int(ti_t[0, 0, 0]) == np.nanargmax(o)
    assert np.all(np.isneginf(m_t[2]))


@pytest.mark.parametrize("S", [129, 256])
def test_scan_chunks_raw_demux_past_one_template_block(jax_pallas, S):
    """scan_chunks_raw on a full-length demuxed bank of more than
    TEMPLATE_BLOCK templates (route "raw-demux+devicePrep", its templates
    in blocks of 128) against detex_tpu's scan_chunks_raw, which scans any
    S in one piece: two chunks at dec 2, one ragged; histogram totals
    exact, maxima within 2e-5, trigger indices exact, the planted event's
    template at the float64 oracle's maximum."""
    dec = 2
    rng = np.random.default_rng(60 + S)
    X = _raw(rng, 2, [(0, 2500)])
    lens = [L_RAW, L_RAW - 1500]
    X[1, :, lens[1]:] = 0.0
    jb0 = jds.build_bank([np.ones((1, NC * N_C))], NC, L_RAW // dec * NC,
                         block_fft=0)
    H = tprep.butter_response(FILT, SR * dec, dec * jb0["nfft2"],
                              device="cpu")
    U_list, xs = _templates(X, lens, [(0, 2500)], H, jb0["nfft2"], dec, S=S)
    jb = jds.build_bank(U_list, NC, L_RAW // dec * NC, block_fft=0)
    tb = tds.bank_from_numpy(_as_np(jb), "cpu")
    assert tds.bank_kind(tb) == "demux" and tb["sum_u"].shape[0] == S
    th = np.full(S, 0.5, np.float32)
    tscan.ROUTE_COUNTS.clear()
    out_t = tscan.scan_chunks_raw(X, lens, H, tb, th, NC, 250, max_trig=4,
                                  dec=dec)
    out_j = jscan.scan_chunks_raw(X, lens, H.numpy(), jb, th, NC, 250,
                                  max_trig=4, dec=dec)
    assert dict(tscan.ROUTE_COUNTS) == {"raw-demux+devicePrep": 1}
    m_t, ti_t, tc_t = _check_scan(out_t, out_j)
    assert m_t.shape == (2, S)
    o = tds.ds_numpy(xs[0], U_list[0], NC)
    assert abs(float(m_t[0, 0]) - float(np.nanmax(o))) <= 2e-5
    assert int(tc_t[0, 0]) == 1 and int(ti_t[0, 0, 0]) == np.nanargmax(o)


def test_scan_station_raw_matches_jax(jax_pallas, tmp_path):
    """serving.scan_station_raw on a tiny artifact with filt and decimate 2
    (the port builds overlap-save banks, detex_tpu on the CPU full-length
    ones; both scan the same preprocessed chunks) against
    detex_tpu.serving.scan_station_raw; a multiplexed bank raises."""
    dec = 2
    rng = np.random.default_rng(50)
    X = _raw(rng, 2, [(1, 3500)])
    lens = [L_RAW, L_RAW]
    nfftp = tds.required_fft_len(L_RAW // dec, N_C)
    H = tprep.butter_response(FILT, SR * dec, dec * nfftp, device="cpu")
    U_list, _ = _templates(X, lens, [(1, 3500)], H, nfftp, dec, S=4, D=1)
    meta = {"stations": {"XX.S01": {"nc": NC, "sr": SR, "detectors": [
        dict(name="SG%d" % s, kind="sg", threshold=0.5, offsets=[0.0],
             mags=[1.0], events=["ev%d" % s]) for s in range(4)]}},
        "filt": FILT, "decimate": dec, "version": 1}
    arrays = {"U__XX.S01__SG%d" % s: U_list[s].astype(np.float32)
              for s in range(4)}
    arrays["meta"] = np.array(json.dumps(meta))
    path = str(tmp_path / "detectors.npz")
    np.savez(path, **arrays)
    chunk_sec = L_RAW / (SR * dec) - 10.0
    dep_j = jserving.load_detectors(path, chunk_sec=chunk_sec, conBuff=10.0)
    dep_t = tserving.load_detectors(path, chunk_sec=chunk_sec, conBuff=10.0,
                                    device="cpu")
    assert dep_t["XX.S01"]["dec"] == dec and dep_t["XX.S01"]["filt"] == FILT
    res_j = jserving.scan_station_raw(dep_j, "XX.S01", X, max_trig=4)
    res_t = tserving.scan_station_raw(dep_t, "XX.S01", X, max_trig=4)
    assert len(res_t) == len(res_j) == 1
    for k in ("hist", "maxds", "trig_idx", "trig_val", "trig_count"):
        assert res_t[0][k].shape == np.asarray(res_j[0][k]).shape, k
    m_t, ti_t, tc_t = _check_scan(
        [res_t[0][k] for k in ("hist", "maxds", "trig_idx", "trig_val",
                               "trig_count")],
        [res_j[0][k] for k in ("hist", "maxds", "trig_idx", "trig_val",
                               "trig_count")])
    assert int(tc_t[1, 0]) == 1 and int(tc_t.sum()) == 1
    mux = tds.build_bank([np.ones((1, NC * N_C + 1))], NC, 3000 * NC, "cpu")
    with pytest.raises(ValueError, match="demuxed bank"):
        tscan.scan_chunks_raw(X, lens, H, mux, np.ones(1), NC, 250, dec=dec)
