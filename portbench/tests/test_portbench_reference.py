"""The float64 reference against small cases worked out by hand."""
import numpy as np
import torch

from portbench.reference import engine64 as ref


def brute_ds(x, U, nc):
    """DS by its definition, window by window: sum_d (u_d . (w - mean w))^2
    over n times the window's sample variance, at every channel-aligned
    start."""
    n = U.shape[1]
    out = []
    for t in range(0, len(x) - n + 1, nc):
        w = x[t:t + n] - x[t:t + n].mean()
        out.append(((U @ w) ** 2).sum() / (w @ w * n / (n - 1)))
    return np.array(out)


def test_ds_matches_its_definition():
    rng = np.random.default_rng(0)
    nc, n = 3, 60
    q, _ = np.linalg.qr(rng.standard_normal((n, 2)))
    U = q.T
    x = rng.standard_normal(600)
    x[300:300 + n] += 5 * U[0] - 3 * U[1]
    bank = ref.Bank([U], len(x), "cpu")
    got = ref.ds_rows(torch.as_tensor(x)[None], bank, nc)[0, 0].numpy()
    want = brute_ds(x, U, nc)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-12
    assert int(np.argmax(got)) == 100            # sample 300 / nc


def test_triggers_take_maxima_and_suppress():
    ds = np.zeros(100)
    ds[[10, 14, 50, 90]] = [0.5, 0.9, 0.31, 0.29]
    assert list(ref.triggers(ds, 0.3, 5)) == [14, 50]
    assert list(ref.triggers(ds, 0.3, 3)) == [14, 10, 50]


def test_stalta_by_hand():
    ds = np.array([1.0, 1, 1, 4, 1, 1, 1, 1])
    got = ref.stalta(ds, 0.6)       # LTA window 5 * 0.6 = 3 samples
    # centred means of 3, the first edge taking the value one past it
    lta = np.array([2, 1, 2, 2, 2, 1, 1, 1.0])
    assert np.allclose(got, ds / lta)


def test_histogram_bins():
    h = ref.histogram(np.array([0.0, 0.001, 0.0025, 0.5, 1.0]))
    assert h.sum() == 5 and h[0] == 2 and h[1] == 1 and h[200] == 1 and \
        h[399] == 1


def test_detrend_and_device_filter_without_band():
    t = np.arange(50.0)
    x = np.stack([3 + 2 * t, -1 - t])
    assert np.abs(ref.detrend(x)).max() < 1e-12
    y = ref.device_prep(torch.as_tensor(x + np.sin(t)), 100.0, None, "cpu")
    assert np.abs(y.numpy() - ref.detrend(x + np.sin(t))).max() < 1e-12


def test_single_template_magnitudes():
    rng = np.random.default_rng(1)
    nc, n = 3, 30
    u = rng.standard_normal(n)
    u /= np.linalg.norm(u)
    det = dict(U=u[None], WFs=4.0 * u[None], mags=[1.5])
    mp = rng.standard_normal(12 * n) * 1e-3
    t = 8 * n // nc
    mp[t * nc:t * nc + n] = 8.0 * u                # twice the template
    mag, snr, pe = ref.magnitudes(det, mp, t, nc, False)
    assert abs(pe - (1.5 + 2.0)) < 1e-2
    assert abs(mag - (1.5 + np.log10(2.0))) < 1e-2
    assert snr > 100


def test_bfloat16_rounding_is_coarse():
    x = np.array([1000.0, 1001.0, 1002.0, 1003.0])
    r = ref.rounded(x, "bfloat16")
    assert np.abs(r - x).max() > 0 and len(set(r)) < 4
    assert np.array_equal(ref.rounded(x, "float64"), x)


def test_device_filter_is_the_zero_phase_response():
    """The device filter against the band-pass run forward and backward in
    float64 (scipy.sosfiltfilt without padding), away from the edges."""
    import scipy.signal as sig
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20000))
    filt = [1.0, 10.0, 2, True]
    got = ref.device_prep(torch.as_tensor(x), 100.0, filt, "cpu").numpy()
    want = sig.sosfiltfilt(ref.bandpass_sos(filt, 100.0), ref.detrend(x),
                           axis=-1, padtype=None)
    mid = slice(3000, 17000)
    assert np.abs(got[:, mid] - want[:, mid]).max() < 1e-6 * want.std()
