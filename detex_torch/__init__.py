"""
detex_torch: PyTorch + CUDA port of detex_tpu's pipeline: the data layer
(``data``: key files, npz waveform directories with their ``.index.db``
and the 'dir' DataFetcher, the synthetic Case1 catalog), detector
construction (``createCluster`` / ``createSubSpace``,
``subspace.SubSpace``: all-pairs clustering, alignment, pick trims, SVD,
FAS thresholds; saved and loaded as pickles of the port's own objects),
association and verification (``detResults``), its detection engine
(``detect.detex``: batched scan, dense re-verify, triggers, magnitudes
and SQLite rows; the per-chunk path with the classify and UTC-save
modes), the directory quality audit and the location-program interop,
its scans over every bank form (template-blocked past 128 templates),
the device preprocessing of raw chunks and serving; phase picks by hand
(``streamPick``, ``util.pickPhases``, ``SubSpace.pickTimes``) or by STA/LTA
(``util.autoPickPhases``, ``SubSpace.autoPickTimes``), the construction
plots, the conversion of the original Detex's pickles (``migrate``) and
the log file (``setLogger``, ``closeLogger``, ``util.readLog``).

The package mirrors detex_tpu's layout (``data/``, ``construct.py``,
``subspace.py``, ``fas.py``, ``results.py``, ``align.py``, ``stats.py``,
``detect.py``, ``util.py``, ``serving.py``, ``quality_check.py``,
``interop.py``, ``core/``, ``ops/ds.py``, ``ops/dft.py``, ``ops/prep.py``,
``ops/rolling.py``, ``ops/stalta.py``, ``ops/triggers.py``,
``ops/xcorr.py``, ``ops/subsample.py``, ``ops/svd.py``,
``parallel/scan.py``, ``streamPick.py``, ``migrate.py``) so every ported
function has an obvious namesake there. Every Pallas kernel of detex_tpu
has a hand-written CUDA C++ counterpart for Hopper (``kernels/``) with a
plain PyTorch twin (``ops/reference.py``) that runs when the caller hands
CPU tensors.

It imports torch, numpy and scipy only: never jax or detex_tpu. The
plots and the picker import matplotlib when they are called, and migrate
reads the pandas DataFrames of a Detex pickle (unpickling imports pandas);
nothing else needs either.
Banks and the correlation and SVD of construction run on the card
(``device="cuda"``) unless the caller passes another device, as the CPU
tests pass "cpu"; every other tensor follows the bank's device. There is
no randomness inside the package.
"""
from __future__ import annotations

import logging
import os

import torch

__version__ = "0.1.0"

_logger = logging.getLogger("detex_torch")
# the log file is deleted and started again when it is larger than this
_MAX_LOG_BYTES = 10 * 1024 * 1024


class DetexError(Exception):
    """An error the engine reports through log(level="error")."""


def log(name, msg, level="info", e=None):
    """Log ``msg`` under the caller's module ``name`` at ``level`` ("info",
    "warning" or "error"); "error" logs, then raises ``e`` (default
    DetexError), as detex_tpu's log does."""
    if level == "error":
        _logger.error("%s: %s", name, msg)
        raise (e or DetexError)(msg)
    if level == "warning":
        _logger.warning("%s: %s", name, msg)
    else:
        _logger.info("%s: %s", name, msg)


def setLogger(fileName="detex_torch.log", deleteOld=False):
    """Write every message of ``log`` to ``fileName`` from now on, one
    line each: time, logger name, level and message, separated by tabs
    (what util.readLog splits). An old file is deleted first when
    ``deleteOld`` is set or when it is larger than 10 MB (reference
    detex/__init__.py:57-93, detex_tpu's setLogger). Returns the
    logger."""
    if os.path.exists(fileName) and (
            deleteOld or os.path.getsize(fileName) > _MAX_LOG_BYTES):
        os.remove(fileName)
    closeLogger()
    _logger.setLevel(logging.DEBUG)
    _logger.propagate = False
    fh = logging.FileHandler(fileName)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(logging.Formatter(
        "%(asctime)s\t%(name)s\t%(levelname)s\t%(message)s"))
    _logger.addHandler(fh)
    return _logger


def closeLogger():
    """Close the log file setLogger opened; messages go back to the
    logging module's own handling."""
    for h in list(_logger.handlers):
        h.close()
        _logger.removeHandler(h)
    _logger.setLevel(logging.NOTSET)
    _logger.propagate = True


def require_cuda():
    """Raise unless a CUDA device of compute capability 9.0 (Hopper) is
    present; returns its name. The hand-written kernels are built for
    ``sm_90a`` and run nowhere else."""
    if not torch.cuda.is_available():
        raise RuntimeError("detex_torch needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    cap = torch.cuda.get_device_capability(0)
    if tuple(cap) != (9, 0):
        raise RuntimeError("detex_torch kernels are built for sm_90a; device "
                           "0 (%s) has compute capability %d.%d"
                           % (torch.cuda.get_device_name(0), cap[0], cap[1]))
    return torch.cuda.get_device_name(0)


from detex_torch import data  # noqa: E402
from detex_torch.construct import createCluster, createSubSpace  # noqa: E402
from detex_torch.results import detResults  # noqa: E402
