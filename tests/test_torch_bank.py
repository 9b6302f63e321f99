"""detex_torch banks, routing rules and package hygiene, held against
detex_tpu on the CPU.

The JAX side builds its banks with DETEX_TPU_PALLAS=1 and
DETEX_TPU_MATMUL_FFT=1 (the switches that make detex_tpu pick the fused
route off the TPU) and a pinned block_fft where its block depends on them.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from detex_tpu.ops import ds as jds
from detex_torch.kernels import build as tbuild
from detex_torch.ops import cuda_kernels as tck
from detex_torch.ops import ds as tds
from detex_torch.parallel import scan as tscan

NC = 3
N = 1680                      # multiplexed template length (n_c = 560)
LC = 3 * 35000
BLK = 16384
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture()
def jax_fused_env(monkeypatch):
    monkeypatch.setenv("DETEX_TPU_PALLAS", "1")
    monkeypatch.setenv("DETEX_TPU_MATMUL_FFT", "1")
    yield


def _U_list(rng, S, D, n=N):
    out = []
    for s in range(S):
        d = D if s % 2 == 0 else max(1, D - 1)      # ragged -> d_mask
        q, _ = np.linalg.qr(rng.standard_normal((d, n)).T)
        out.append(np.ascontiguousarray(q[:, :d].T))
    return out


def test_bank_parity_keys_shapes_values():
    """Same keys, shapes and statics as detex_tpu's overlap-save bank;
    template spectra equal to float32 rounding (the port transforms in
    float64 on the host, detex_tpu in float32)."""
    U_list = _U_list(np.random.default_rng(1), S=3, D=4)
    jb = jds.build_bank(U_list, NC, LC, prefer_os=True, block_fft=BLK)
    tb = tds.build_bank(U_list, NC, LC, "cpu", block_fft=BLK)
    assert set(jb) == set(tb)
    for k, v in jb.items():
        if hasattr(v, "shape"):
            assert tuple(tb[k].shape) == tuple(v.shape), k
        else:
            assert tb[k] == v, k
    np.testing.assert_allclose(tb["Ufd2"].numpy(), np.asarray(jb["Ufd2"]),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(tb["sum_u"].numpy(), np.asarray(jb["sum_u"]),
                               rtol=1e-6, atol=1e-6)
    assert np.array_equal(tb["d_mask"].numpy(), np.asarray(jb["d_mask"]))


def test_bank_spec_pair_parity():
    """The weighted (real, imag) spectra pair [Dmax, S, nc, Rp] matches
    detex_tpu's f32 pair on identical spectra (bank_from_numpy)."""
    U_list = _U_list(np.random.default_rng(2), S=3, D=2)
    jb = jds.build_bank(U_list, NC, LC, prefer_os=True, block_fft=BLK)
    tb = tds.bank_from_numpy({k: np.asarray(v) if hasattr(v, "shape") else v
                              for k, v in jb.items()}, "cpu")
    jur, jui = jds.bank_spec_pair(jb, "f32")
    tur, tui = tds.bank_spec_pair(tb)
    assert tuple(tur.shape) == tuple(jur.shape)
    np.testing.assert_allclose(tur.numpy(), np.asarray(jur), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(tui.numpy(), np.asarray(jui), rtol=1e-6,
                               atol=1e-9)


def test_bank_from_numpy_carries_weights():
    """bank_from_numpy turns a detex_tpu bank's numpy arrays into the
    port's bank with bit-identical spectra and the same statics, for the
    overlap-save, full-length demuxed and multiplexed forms; a dict that
    is none of them (an overlap-save bank without its flag) raises."""
    U_list = _U_list(np.random.default_rng(3), S=2, D=3)
    for kw, kind, spec, statics in (
            (dict(prefer_os=True, block_fft=BLK), "os", "Ufd2",
             ("n", "n_c", "Dmax", "nc", "blk_fft", "pad_len")),
            (dict(block_fft=0), "demux", "Ufd2",
             ("n", "n_c", "Dmax", "nc", "nfft2", "pad_len")),
            (dict(), "mux", "Ufd", ("n", "Dmax", "nc", "nfft", "pad_len"))):
        U = U_list if kind != "mux" else [u[:, :N - 1] for u in U_list]
        jb = jds.build_bank(U, NC, LC, **kw)
        d = {k: (np.asarray(v) if hasattr(v, "shape") else v)
             for k, v in jb.items()}
        tb = tds.bank_from_numpy(d, "cpu")
        assert tds.bank_kind(tb) == kind and set(tb) == set(d)
        assert tb[spec].dtype == torch.complex64
        assert np.array_equal(tb[spec].numpy(), d[spec].astype(np.complex64))
        for k in statics:
            assert tb[k] == d[k]
        if kind == "os":
            with pytest.raises(ValueError, match="not an overlap-save"):
                tds.bank_kind(tds.bank_from_numpy(dict(d, os=False), "cpu"))


def test_block_snap_is_unconditional(jax_fused_env):
    """The port snaps a short template's natural block up to 16384 with no
    environment switch, as detex_tpu does only with its fused route on."""
    U_list = _U_list(np.random.default_rng(4), S=1, D=2)
    tb = tds.build_bank(U_list, NC, LC, "cpu")
    jb = jds.build_bank(U_list, NC, LC, prefer_os=True)
    assert tb["blk_fft"] == jb["blk_fft"] == BLK


@pytest.mark.parametrize("k", [1, 8, 9, 63, 65, 100, 129, 1000])
def test_shape_ladders_match(k):
    assert tds.pad_rows(k) == jds.pad_rows(k)
    assert tds.pad_dims(k) == jds.pad_dims(k)


def test_builder_raises_without_nvcc(monkeypatch, tmp_path):
    """With no nvcc anywhere the kernel build raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    monkeypatch.setattr(tbuild, "NVCC_DEFAULT", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tbuild.load_library(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_wrappers_dispatch_on_device():
    """CPU tensors run the twin and count no kernel launch; a tensor on a
    device with no kernel raises instead of falling back."""
    tck.reset_launches()
    xq = torch.zeros((1, NC, 3 * 15744 + 640), dtype=torch.float32)
    fr, _, a, _ = tck.fwd_prep_fold(xq, NC, 560, BLK, 40000)
    assert fr.device.type == "cpu" and a.shape == (1, 3 * 15744)
    spec = tck.rfft_ct_fused(xq[0, :, :BLK].contiguous(), BLK)
    assert spec.dtype == torch.complex64 and spec.shape == (NC, BLK // 2 + 1)
    cb = tck.irfft_ct_fused(spec, BLK)
    assert cb.shape == (NC, BLK)
    ds, pyr, _ = tck.ds_finalize_os_fold(
        cb.reshape(NC, 1, BLK), a[:, :15744], a[:, :15744] + 1,
        torch.zeros(NC), torch.tensor([5], dtype=torch.int32), 640, 1,
        15744, group=NC)
    assert ds.shape == (NC, 15744) and pyr.shape == (NC, 123)
    fr, fi = tck.rfft_ct_half(xq[0, :, :BLK].contiguous(), BLK)
    assert fr.shape == fi.shape == (NC, 8320)
    stats = (a[0, :15744].contiguous(), a[0, :15744] + 1)
    su = torch.zeros(NC)
    nv = torch.tensor([5], dtype=torch.int32)
    ds, pyr, hist = tck.ds_finalize_os_scan(cb.reshape(NC, 1, BLK), *stats,
                                            su, nv, 640, 1, 15744, nbin=400)
    assert ds.shape == (NC, 15744) and pyr.shape == (NC, 123)
    assert hist.shape == (NC, 400) and hist.dtype == torch.int32
    ds = tck.ds_finalize_os(cb.reshape(NC, 1, BLK), *stats, su, 640, 1,
                            15744)
    assert ds.shape == (NC, 15744)
    hist = tck.hist_uniform(ds, 400)
    assert hist.shape == (NC, 400) and hist.dtype == torch.int32
    cc = cb.reshape(1, NC, BLK)
    fin = (a[0, :BLK].contiguous(), a[0, :BLK] + 1, torch.zeros(1, NC))
    ds = tck.ds_finalize(cc, *fin)
    assert ds.shape == (1, BLK)
    assert set(tck.LAUNCHES) == {
        "fwd_prep_fold", "spec_ds_fold", "ds_finalize_os_fold",
        "rfft_ct_fused", "irfft_ct_fused", "rfft_ct_half",
        "ds_finalize_os_scan", "ds_finalize_os", "hist_uniform",
        "ds_finalize"}
    assert not any(tck.LAUNCHES.values())
    meta = [lambda: tck.fwd_prep_fold(xq.to("meta"), NC, 560, BLK, 40000),
            lambda: tck.rfft_ct_fused(xq[0, :, :BLK].to("meta"), BLK),
            lambda: tck.irfft_ct_fused(spec.to("meta"), BLK),
            lambda: tck.rfft_ct_half(xq[0, :, :BLK].to("meta"), BLK),
            lambda: tck.ds_finalize_os_scan(
                cb.reshape(NC, 1, BLK).to("meta"), *(t.to("meta") for t in
                                                     stats),
                su.to("meta"), nv.to("meta"), 640, 1, 15744),
            lambda: tck.ds_finalize_os(
                cb.reshape(NC, 1, BLK).to("meta"), *(t.to("meta") for t in
                                                     stats),
                su.to("meta"), 640, 1, 15744),
            lambda: tck.hist_uniform(ds.to("meta"), 400),
            lambda: tck.ds_finalize(cc.to("meta"),
                                    *(t.to("meta") for t in fin))]
    for call in meta:
        with pytest.raises(ValueError, match="no kernel for device"):
            call()


def test_port_imports_without_jax_or_pandas():
    """In a process where jax, detex_tpu, pandas and matplotlib cannot be
    imported, detex_torch still imports (the engine, its host modules,
    core, the detector construction, the data layer and results included)
    and runs a CPU scan, a dense re-verify, a per-chunk ("plain") scan,
    run_bank, a full-length bank's scan and raw scan with the device prep,
    the detection engine on two chunks of one station, writing its rows
    to SQLite, imports quality_check and interop, classifies one chunk
    (the classify mode's EventCors table written and read back as row
    dicts), and a tiny createCluster -> createSubSpace -> attachPickTimes
    -> SVD(threshold) on the CPU, and writes a tiny SynthCatalog
    directory, indexes it and reads one chunk back through the 'dir'
    fetcher, and runs a scan sharded over a 4-entry CPU mesh
    (parallel.mesh) and a miniSEED round trip of that chunk through the
    port's native library (native, data.mseed); it imports the pickers,
    the plots' module and migrate, runs autoPickTimes on the tiny
    SubSpace, autoPickPhases on the SynthCatalog's events and the log
    file's round trip, and holds that a detex_tpu pickle is refused
    before import while a Detex pickle reaches migrate. The imports are
    refused by a finder at the head of sys.meta_path (a None entry in
    sys.modules would also break scipy's check for JAX arrays inside
    scipy.cluster)."""
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'pandas',\n"
        "                                  'detex_tpu', 'matplotlib'):\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "from detex_torch.ops import ds\n"
        "from detex_torch.parallel import scan\n"
        "import detex_torch.serving\n"
        "rng = np.random.default_rng(0)\n"
        "U = np.linalg.qr(rng.standard_normal((1680, 2)))[0].T\n"
        "bank = ds.build_bank([U], 3, 3 * 35000, 'cpu')\n"
        "X = rng.standard_normal((2, 3 * 35000)).astype(np.float32)\n"
        "out = scan.scan_chunks(X, bank, np.ones(1), 3, 250,\n"
        "                       calc_triggers=False)\n"
        "assert out[0].sum() > 0 and out[1].shape == (2, 1)\n"
        "trig = ds.run_bank_triggers_batch(list(X), bank, 3, [[0], [0]],\n"
        "                                  [[0.5], [0.5]], [100.0] * 2,\n"
        "                                  5.0, 0.0, True)\n"
        "assert len(trig) == 2 and len(trig[0][0][0]) == 0\n"
        "scan.ROUTE_COUNTS.clear()\n"
        "out = scan.scan_chunks(X, bank, np.ones(1), 3, 250,\n"
        "                       bins=np.linspace(0, 1, 11) ** 2)\n"
        "assert dict(scan.ROUTE_COUNTS) == {'plain': 1}\n"
        "assert out[0].sum() == 2 * (35000 - 560 + 1)\n"
        "assert ds.run_bank(X[0], bank, 3).shape == (1, 35000 - 560 + 1)\n"
        "from detex_torch.ops import prep\n"
        "full = ds.build_bank([U], 3, 3 * 35000, 'cpu', prefer_os=False)\n"
        "assert ds.bank_kind(full) == 'demux'\n"
        "out = scan.scan_chunks(X, full, np.ones(1), 3, 250)\n"
        "assert out[0].sum() == 2 * (35000 - 560 + 1)\n"
        "H = prep.butter_response([1, 8, 2, True], 25.0, full['nfft2'],\n"
        "                         device='cpu')\n"
        "Xc = X.reshape(2, 35000, 3).transpose(0, 2, 1)\n"
        "out = scan.scan_chunks_raw(Xc, [35000] * 2, H, full, np.ones(1), 3,\n"
        "                           250)\n"
        "assert out[1].shape == (2, 1)\n"
        "import os, tempfile\n"
        "import detex_torch.core, detex_torch.construct, detex_torch.util\n"
        "from detex_torch import detect\n"
        "from detex_torch.core import Stream, Trace\n"
        "Xe = X.copy()\n"
        "Xe[1, 3 * 9000:3 * 9000 + 1680] += 150.0 * U[0]\n"
        "def chunks(sta):\n"
        "    for b in range(2):\n"
        "        st = Stream([Trace(Xe[b, c::3].astype(np.float64), dict(\n"
        "            network='XX', station='S1', channel='BH' + 'ENZ'[c],\n"
        "            sampling_rate=25.0, starttime=1e9 + 1400.0 * b))\n"
        "            for c in range(3)])\n"
        "        yield st, None, None\n"
        "det = dict(name='d0', U=U, WFs=U * 3.0, mags=[1.0, 1.2],\n"
        "           events=['e0', 'e1'], offsets=[0.0, 0.5], threshold=0.5)\n"
        "stations = {'XX.S1': dict(channels=['BHE', 'BHN', 'BHZ'], sr=25.0,\n"
        "                           detectors=[det])}\n"
        "db = os.path.join(tempfile.mkdtemp(), 'ss.db')\n"
        "hist = detect.detex(stations, chunks, db, conDatDuration=1300.0,\n"
        "                    conBuff=100.0, device='cpu')\n"
        "assert hist['XX.S1']['d0'].sum() == 2 * (35000 - 560 + 1)\n"
        "rows = detex_torch.util.loadSQLite(db, 'ss_df')\n"
        "assert [r['STMP'] for r in rows] == [1e9 + 1400.0 + 9000 / 25.0]\n"
        "from detex_torch import quality_check, interop\n"
        "cwd, wdir = os.getcwd(), tempfile.mkdtemp()\n"
        "os.chdir(wdir)\n"
        "detect.detex(stations, lambda sta: iter([next(chunks(sta))]),\n"
        "             'c.db', conDatDuration=1300.0, conBuff=100.0,\n"
        "             classifyEvents=True, device='cpu')\n"
        "ec = detex_torch.util.readRows('EventCors_XX.S1.pkl')\n"
        "assert [list(r) for r in ec] == [['Sta', 'Name', 'DS', 'TimeStamp']]\n"
        "assert ec[0]['Name'] == 'd0' and ec[0]['TimeStamp'] == 1e9\n"
        "os.chdir(cwd)\n"
        "from detex_torch import construct, subspace, fas, align, stats\n"
        "from detex_torch.ops import xcorr\n"
        "r2 = np.random.default_rng(1)\n"
        "fam = [r2.standard_normal(150) * np.hanning(150) for _ in 'ab']\n"
        "streams, templates, picks = {'XX.S1': {}}, {}, []\n"
        "for k in range(5):\n"
        "    name, t0, at = 'ev%d' % k, 1e9 + 1000.0 * k, 100 + 3 * k\n"
        "    data = 0.05 * r2.standard_normal((3, 400))\n"
        "    data[:, at:at + 150] += (fam[k % 2] if k < 4\n"
        "                             else r2.standard_normal(150))\n"
        "    streams['XX.S1'][name] = Stream([Trace(data[c], dict(\n"
        "        network='XX', station='S1', channel='BH' + 'ENZ'[c],\n"
        "        sampling_rate=25.0, starttime=t0)) for c in range(3)])\n"
        "    templates[name] = {'time': t0 + 4.0, 'mag': 1.0 + k / 10}\n"
        "    picks.append(dict(TimeStamp=t0 + at / 25.0, Station='XX.S1',\n"
        "                      Event=name, Phase='P'))\n"
        "cl = construct.createCluster(streams=streams, templates=templates,\n"
        "                             filt=[1, 8, 2, 1], trim=[4, 12],\n"
        "                             saveclust=False, device='cpu')\n"
        "assert sorted(map(sorted, cl['S1'].clusts)) == \\\n"
        "    [['ev0', 'ev2'], ['ev1', 'ev3']]\n"
        "assert cl['S1'].singles == ['ev4']\n"
        "ss = construct.createSubSpace(clust=cl)\n"
        "ss.attachPickTimes(picks, defaultDuration=4)\n"
        "ss.SVD(threshold=0.5)\n"
        "rows = ss.subspaces['XX.S1'] + ss.singles['XX.S1']\n"
        "assert [r['Threshold'] for r in rows] == [0.5] * 3\n"
        "assert [r['NumBasis'] for r in rows[:2]] == [1, 1]\n"
        "import detex_torch.data, detex_torch.results\n"
        "from detex_torch.data import fetcher\n"
        "from detex_torch.data.synth import SynthCatalog\n"
        "cat = SynthCatalog(n_sources=1, events_per_source=2, n_singles=0,\n"
        "                   n_stations=1, sr=10.0, span_hours=3, seed=0)\n"
        "paths = cat.write_directories(tempfile.mkdtemp(), tb4=5, taft=20)\n"
        "fetcher.indexDirectory(paths['conDir'])\n"
        "cf = fetcher.DataFetcher('dir', directoryName=paths['conDir'])\n"
        "st = next(cf.getConData(paths['stationKey']))\n"
        "assert len(st) == 3 and len(st[0].data) == 37200\n"
        "from detex_torch import native\n"
        "from detex_torch.parallel import mesh\n"
        "from detex_torch.data import mseed, waveio\n"
        "m4 = mesh.make_mesh(devices=['cpu'] * 4)\n"
        "scan.ROUTE_COUNTS.clear()\n"
        "out4 = scan.scan_chunks(X[[0, 1, 0]], bank, np.ones(1), 3, 250,\n"
        "                        mesh=m4)\n"
        "out1 = scan.scan_chunks(X[[0, 1, 0]], bank, np.ones(1), 3, 250)\n"
        "assert 'fused-sub+fusedprep+sharded' in scan.ROUTE_COUNTS\n"
        "assert out4[0].equal(out1[0]) and out4[1].shape == (3, 1)\n"
        "assert native.available()\n"
        "assert str(native.library_path()).startswith(\n"
        "    os.path.join(os.path.dirname(detex_torch.__file__), 'kernels'))\n"
        "ms = os.path.join(tempfile.mkdtemp(), 'x.msd')\n"
        "st.write(ms, 'mseed')\n"
        "back = waveio.read(ms)\n"
        "assert [t.id for t in back] == [t.id for t in st]\n"
        "assert all(np.array_equal(a.data, b.data) for a, b in\n"
        "           zip(back, st))\n"
        "import detex_torch.streamPick, detex_torch.migrate\n"
        "from detex_torch.util import (pickPhases, seeWaveFroms,\n"
        "                              autoPickPhases, readLog)\n"
        "from detex_torch.ops.rolling import rolling_sum\n"
        "from detex_torch.ops.ds import ds_single\n"
        "ss2 = construct.createSubSpace(clust=cl)\n"
        "ss2.autoPickTimes(duration=4)\n"
        "rows = ss2.subspaces['XX.S1'] + ss2.singles['XX.S1']\n"
        "assert all(r['SampleTrims'] for r in rows) and len(rows) == 3\n"
        "pk = os.path.join(tempfile.mkdtemp(), 'picks.csv')\n"
        "autoPickPhases(paths['templateKey'], paths['stationKey'],\n"
        "               paths['eventDir'], pk, tb4=5, taft=20)\n"
        "assert open(pk).readline().strip() == \\\n"
        "    'TimeStamp,Station,Event,Phase'\n"
        "lg = os.path.join(tempfile.mkdtemp(), 'x.log')\n"
        "detex_torch.setLogger(lg)\n"
        "detex_torch.log('m', 'logged')\n"
        "detex_torch.closeLogger()\n"
        "assert readLog(lg)[0]['Msg'] == 'm: logged'\n"
        "for body, says in (\n"
        "        (b'cdetex_tpu.subspace\\nSubSpace\\n', 'of detex_tpu'),\n"
        "        (b'cdetex.subspace\\nSubSpace\\n', 'Detex SubSpace')):\n"
        "    fp = os.path.join(tempfile.mkdtemp(), 'old.pkl')\n"
        "    with open(fp, 'wb') as fh:\n"
        "        fh.write(b'\\x80\\x02' + body + b'q\\x00)\\x81q\\x01.')\n"
        "    try:\n"
        "        detex_torch.util.loadSubSpace(fp, device='cpu')\n"
        "    except NotImplementedError as e:\n"
        "        assert says in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('not refused: ' + says)\n"
        "bad = [m for m in ('jax', 'pandas', 'detex_tpu', 'matplotlib')\n"
        "       if sys.modules.get(m) is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
