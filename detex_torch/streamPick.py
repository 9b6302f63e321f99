"""
Interactive phase picker on plain matplotlib, with a headless way to drive
it: ``show=False`` and :meth:`streamPick.feed_key`.

Namesake of detex_tpu/streamPick.py (reference detex/streamPick.py, a
PyQt4 port of miili/StreamPick): the same keyboard workflow under any
interactive matplotlib backend, on the port's core.stream Stream and
core.utc UTCDateTime. matplotlib is imported when a picker is made, so
importing this module needs none.

Key bindings (reference streamPick.py:71-83; a key pressed with the cursor
over a trace picks there, where the reference took a key held during a
left click):

  ======  ==========================================================
  q / a   pick P / Pend at the cursor position
  w / s   pick S / Send
  t       pick the custom phase (``custom_phase``, default "Custom")
  r       remove this channel's picks
  f       toggle the display bandpass filter (``bpfilter[0]``)
  1 / 2   gain up / down (display only)
  c / x   next / previous station
  v       finish this stream, caller's loop continues (KeepGoing=True)
  escape  close and abort the caller's loop (KeepGoing stays False)
  ======  ==========================================================

Picks land on ``._picks`` as :class:`Pick` objects with the fields of
obspy's ``event.Pick`` that the pick consumers read (``phase_hint``,
``time.timestamp``, ``waveform_id.channel_code``), by attribute or by item
(reference subspace.py:1379-1381, util.py:1070-1075).

Blocking: under an interactive backend, making ``streamPick(st)`` blocks
until its window closes, as the reference's constructor runs the Qt event
loop (streamPick.py:94); the caller then reads ``._picks`` and
``.KeepGoing``. With ``show=False``, or a non-interactive backend such as
Agg, it returns at once and :meth:`feed_key` drives it.
"""
from __future__ import annotations

import itertools
import json

import numpy as np

import detex_torch

#: phase picked per key (reference _shortcuts, streamPick.py:71-83)
_PICK_KEYS = {"q": "P", "a": "Pend", "w": "S", "s": "Send"}
_FILTER_FILE = ".pick_filters"


class AttrDict(dict):
    """dict with attribute access — picks must answer both ``b.time`` and
    ``b['time']`` (the reference consumers use both styles)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value


class WaveformStreamID(AttrDict):
    """Subset of obspy.event.WaveformStreamID the consumers read."""

    def __init__(self, network_code="", station_code="", location_code="",
                 channel_code=""):
        super().__init__(network_code=network_code,
                         station_code=station_code,
                         location_code=location_code,
                         channel_code=channel_code)


class Pick(AttrDict):
    """Subset of obspy.event.Pick produced by the picker (reference
    _setPick, streamPick.py:324-361)."""

    def __init__(self, **kw):
        super().__init__(time=None, phase_hint="", waveform_id=None,
                         polarity="undecideable", onset="impulsive",
                         evaluation_mode="manual",
                         evaluation_status="preliminary")
        self.update(kw)


def _load_filters():
    """The display bandpass presets kept between sessions in
    ``.pick_filters`` of the working directory (json; the reference
    pickles it)."""
    try:
        with open(_FILTER_FILE) as fh:
            flts = json.load(fh)
        return [dict(f) for f in flts] if isinstance(flts, list) else []
    except (OSError, ValueError, TypeError):
        return []


class streamPick(object):
    """
    Matplotlib phase picker over a :class:`detex_torch.core.Stream` (or
    any stream with the same Trace / Stats API).

    Parameters
    ----------
    stream : Stream
        Waveforms to pick; one subplot per trace of the current station.
    parent, ap : ignored
        Accepted for reference API compatibility (Qt parent / QApplication).
    show : bool or None
        Block in an interactive window (default: only when the matplotlib
        backend is interactive). ``show=False`` returns immediately for
        scripted use — drive with :meth:`feed_key`, then read ``._picks``.
    custom_phase : str
        Phase name the 't' key picks (the reference popped a Qt input
        dialog; a keyboard-only UI takes it as a parameter).
    bpfilter : list of dict or None
        Display bandpass presets [{"freqmin", "freqmax", "corners",
        "zerophase"}, ...]; defaults to the persisted ``.pick_filters``.
    """

    def __init__(self, stream=None, parent=None, ap=None, show=None,
                 custom_phase="Custom", bpfilter=None):
        if stream is None or len(stream) < 1:
            detex_torch.log(__name__, "Define stream = core.Stream()",
                            level="error", e=ValueError)
        import matplotlib
        import matplotlib.pyplot as plt
        self._plt = plt
        self.st = stream.copy()
        self.st.merge()
        self.KeepGoing = False
        self._picks = []
        self.savefile = None
        self.custom_phase = str(custom_phase)
        self.bpfilter = (list(bpfilter) if bpfilter is not None
                         else _load_filters())
        self._filter_index = None      # None = raw display
        self._gain = 1.0
        self._closed = False
        self._initStations()
        self._stationCycle = itertools.cycle(self._stations)
        self._streamStation(next(self._stationCycle))
        if show is None:
            show = matplotlib.get_backend().lower() not in (
                "agg", "pdf", "ps", "svg", "cairo", "template")
        self.fig = plt.figure(figsize=(12, 8))
        self.fig.canvas.mpl_connect("key_press_event", self._onKey)
        self.fig.canvas.mpl_connect("close_event", self._onClose)
        self._drawFig()
        if show:                                        # pragma: no cover
            plt.show(block=True)

    # -- display --------------------------------------------------------
    def _initStations(self):
        self._stations = sorted({tr.stats.station for tr in self.st})

    def _streamStation(self, station):
        if station not in self._stations:
            return
        self._current_st = self.st.select(station=station).copy()
        self._current_st.sort(["channel"])
        self._current_st.detrend("linear")
        self._current_stname = station
        self._current_network = self._current_st[0].stats.network

    def _displayed_st(self):
        """The plotted view: the current station's stream with the active
        display filter applied (picking is on raw sample positions, so the
        filter never shifts pick times — zerophase recommended)."""
        st = self._current_st.copy()
        if self._filter_index is not None and self.bpfilter:
            f = self.bpfilter[self._filter_index % len(self.bpfilter)]
            try:
                st.filter("bandpass", freqmin=f["freqmin"],
                          freqmax=f["freqmax"],
                          corners=int(f.get("corners", 2)),
                          zerophase=bool(f.get("zerophase", True)))
            except (KeyError, ValueError) as exc:
                detex_torch.log(__name__, "display filter failed: %s" % exc,
                                level="warning")
        return st

    def _drawFig(self):
        st = self._displayed_st()
        self.fig.clear()
        axes = self.fig.subplots(len(st), 1, squeeze=False)[:, 0]
        for ax, tr in zip(axes, st):
            ax.plot(tr.data, "k", lw=0.7)
            ax.axhline(0, color="k", alpha=0.05)
            ax.set_xlim(0, max(tr.data.size, 1))
            amp = float(np.nanmax(np.abs(tr.data))) if tr.data.size else 1.0
            amp = (amp or 1.0) / max(self._gain, 1e-9)
            ax.set_ylim(-amp, amp)
            ax.text(0.925, 0.9, tr.stats.channel, transform=ax.transAxes,
                    va="top")
            ax.channel = tr.stats.channel
        axes[-1].set_xlabel("Sample (%.6g sps)"
                            % st[0].stats.sampling_rate)
        s0 = self._current_st[0].stats
        self.fig.suptitle("%s - %s - %s" % (s0.network, s0.station,
                                            s0.starttime.isoformat()), x=0.2)
        self._drawPicks(draw=False)
        self._canvasDraw()

    def _drawPicks(self, draw=True):
        t0 = self._current_st[0].stats.starttime
        delta = self._current_st[0].stats.delta
        colors = {"P": "C3", "Pend": "C1", "S": "C0", "Send": "C2"}
        for ax in self.fig.get_axes():
            for ln in list(getattr(ax, "_picklines", [])):
                ln.remove()
            ax._picklines = []
            for pk in self._getPicks():
                if pk.waveform_id.channel_code != ax.channel:
                    continue
                x = (pk.time - t0) / delta
                ln = ax.axvline(x, color=colors.get(pk.phase_hint, "C4"),
                                lw=1.2)
                txt = ax.text(x, ax.get_ylim()[1] * 0.9, pk.phase_hint,
                              color=ln.get_color(), fontsize=8, va="top")
                ax._picklines += [ln, txt]
        if draw:
            self._canvasDraw()

    def _canvasDraw(self):
        try:
            self.fig.canvas.draw_idle()
        except Exception:                               # pragma: no cover
            pass

    # -- events -----------------------------------------------------------
    def _onKey(self, event):
        self.feed_key(event.key, xdata=event.xdata, inaxes=event.inaxes)

    def feed_key(self, key, xdata=None, inaxes=None, channel=None):
        """Dispatch one key gesture. The matplotlib handler funnels here;
        scripted callers (tests, batch repicking) call it directly with
        ``channel=`` instead of a hovered axes object."""
        if key is None:
            return
        key = key.lower() if len(key) == 1 else key
        if channel is None and inaxes is not None:
            channel = getattr(inaxes, "channel", None)
        if key in _PICK_KEYS or key == "t":
            if channel is None or xdata is None:
                return
            phase = _PICK_KEYS.get(key, self.custom_phase)
            self._setPick(xdata, phase, channel,
                          polarity=self._polarity(channel, xdata))
            self._drawPicks()
        elif key == "r" and channel is not None:
            self._delPicks(self._current_network, self._current_stname,
                           channel)
            self._drawPicks()
        elif key == "c":
            self._pltNextStation()
        elif key == "x":
            self._pltPrevStation()
        elif key == "f":
            if self.bpfilter:
                self._filter_index = (0 if self._filter_index is None
                                      else None)
                self._drawFig()
        elif key == "1":
            self._gain *= 2.0
            self._drawFig()
        elif key == "2":
            self._gain /= 2.0
            self._drawFig()
        elif key == "v":
            self._pltNextStream()
        elif key == "escape":
            self._close()

    def _polarity(self, channel, xdata):
        """First-motion polarity from the displayed trace (reference
        streamPick.py:510-518: sign of data[x+3] - data[x])."""
        st = self._displayed_st().select(channel=channel)
        if not len(st):
            return "undecideable"
        d = st[0].data
        i = int(xdata)
        if i < 0 or i + 3 >= d.size:
            return "undecideable"
        amp = d[i + 3] - d[i]
        return ("negative" if amp < 0 else
                "positive" if amp > 0 else "undecideable")

    # -- picks ------------------------------------------------------------
    def _setPick(self, xdata, phase, channel, polarity="undecideable"):
        s0 = self._current_st[0].stats
        picktime = s0.starttime + xdata * s0.delta
        this = None
        for pk in self._getPicks():       # overwrite same phase+channel
            if (pk.phase_hint == phase
                    and pk.waveform_id.channel_code == channel):
                this = pk
                break
        new = this is None
        if new:
            this = Pick()
            self._picks.append(this)
        this.time = picktime
        this.phase_hint = phase
        this.waveform_id = WaveformStreamID(
            network_code=s0.network, station_code=s0.station,
            location_code=s0.location, channel_code=channel)
        this.polarity = polarity
        if self._filter_index is not None and self.bpfilter:
            this.comments = [str(self.bpfilter[self._filter_index])]

    def _delPicks(self, network, station, channel):
        self._picks = [pk for pk in self._picks
                       if not (pk.waveform_id.network_code == network
                               and pk.waveform_id.station_code == station
                               and pk.waveform_id.channel_code == channel)]

    def _getPicks(self):
        """Picks belonging to the currently displayed station/window."""
        s0 = self._current_st[0].stats
        out = []
        for pk in self._picks:
            if (pk.waveform_id.station_code == self._current_stname
                    and s0.starttime <= pk.time
                    and pk.time <= s0.endtime + s0.delta):
                out.append(pk)
        return out

    def getPicks(self):
        return list(self._picks)

    # -- navigation / lifecycle -------------------------------------------
    def _pltNextStation(self):
        self._streamStation(next(self._stationCycle))
        self._drawFig()

    def _pltPrevStation(self):
        prev = None
        for _ in range(max(len(self._stations) - 1, 1)):
            prev = next(self._stationCycle)
        if prev is not None:
            self._streamStation(prev)
        self._drawFig()

    def _pltNextStream(self):
        """Finish this stream: the caller's loop continues (reference
        streamPick.py:598-608)."""
        self.KeepGoing = True
        try:
            with open(_FILTER_FILE, "w") as fh:
                json.dump(self.bpfilter, fh)
        except OSError:                                 # pragma: no cover
            pass
        self._close()

    def _onClose(self, _event=None):
        self._closed = True

    def _close(self):
        if not self._closed:
            self._closed = True
            try:
                self._plt.close(self.fig)
            except Exception:                           # pragma: no cover
                pass
