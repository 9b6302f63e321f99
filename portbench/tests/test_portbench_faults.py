"""The comparison that decides ``correct``, on the CPU at the tiny size:
sound runs pass it, and each fault a cell can have, planted in the timed
path underneath a run, makes it fail."""
import pytest
import torch

from conftest import run_tiny


@pytest.mark.parametrize("traffic", ["archive", "swarm", "feed"])
def test_sound_run_is_correct(traffic):
    result, nums, lines = run_tiny(traffic)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0


def _zero_scan(monkeypatch):
    """A scan that returns its summaries untouched: no histogram counts
    and zero maxima (the state it was handed)."""
    from detex_torch.parallel import scan

    def stuck(fn):
        def inner(*a, **kw):
            out = fn(*a, **kw)
            return (torch.zeros_like(out[0]), torch.zeros_like(out[1])) + \
                tuple(out[2:])
        return inner
    monkeypatch.setattr(scan, "scan_chunks", stuck(scan.scan_chunks))
    monkeypatch.setattr(scan, "scan_chunks_raw", stuck(scan.scan_chunks_raw))


def _half_batch(monkeypatch):
    """Half of every batch left out of the scan (its chunks masked as
    empty), the summaries taken over the rest."""
    from detex_torch.parallel import scan
    orig = scan.scan_chunks

    def half(X, bank, th, nc, *a, valid_lens=None, **kw):
        if valid_lens is not None:
            valid_lens = list(valid_lens)
            h = len(valid_lens) // 2
            valid_lens[h:] = [0] * (len(valid_lens) - h)
        return orig(X, bank, th, nc, *a, valid_lens=valid_lens, **kw)
    monkeypatch.setattr(scan, "scan_chunks", half)
    orig_raw = scan.scan_chunks_raw

    def half_raw(Xc, lens, *a, **kw):
        lens = list(lens)
        h = len(lens) // 2
        lens[h:] = [0] * (len(lens) - h)
        return orig_raw(Xc, lens, *a, **kw)
    monkeypatch.setattr(scan, "scan_chunks_raw", half_raw)


def _no_exchange(monkeypatch):
    """The engine on a mesh of four CPU entries whose gather keeps only the
    first shard's histograms and maxima: the exchange between cards left
    out."""
    from detex_torch.parallel import mesh as pmesh
    from detex_torch.parallel import scan
    monkeypatch.setattr(scan, "engine_mesh",
                        lambda device=None: pmesh.make_mesh(
                            devices=["cpu"] * 4))
    orig = scan._gather

    def first_only(m, outs, B):
        outs = [outs[0]] + [tuple(torch.zeros_like(t) for t in o)
                            for o in outs[1:]]
        return orig(m, outs, B)
    monkeypatch.setattr(scan, "_gather", first_only)


def _altered_answer(monkeypatch):
    """Each detection row's DS altered by 1e-3 where the row is made."""
    from detex_torch import detect
    orig = detect._SSDetex._coeffRowList

    def altered(self, idx, coefs, *a, **kw):
        return orig(self, idx, [float(c) + 1e-3 for c in coefs], *a, **kw)
    monkeypatch.setattr(detect._SSDetex, "_coeffRowList", altered)


FAULTS = {"state_unchanged": _zero_scan, "half_batch": _half_batch,
          "exchange_left_out": _no_exchange,
          "answer_altered": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("traffic", ["swarm", "feed"])
def test_fault_is_not_correct(monkeypatch, fault, traffic):
    FAULTS[fault](monkeypatch)
    result, nums, lines = run_tiny(traffic)
    assert not result["correct"], lines
