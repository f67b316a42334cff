"""Progress/error listener surface (a copy of
``art_tpu/pipeline/listeners.py``; reference: rtengine.h:150-166
`ProgressListener` — setProgress / setProgressStr / setProgressState /
error; milestones fired through simpleprocess.cc:117-486).

The device pipeline is one compiled program, so the reference's 23
per-step callbacks collapse to phase milestones around it; the phase
set mirrors simpleprocess' stage_init / stage_denoise+transform (device)
/ stage_finish (encode) granularity.
"""

from __future__ import annotations


class ProgressListener:
    """Subclass and override; all methods optional no-ops."""

    def set_progress(self, pct: float) -> None:  # 0..1
        pass

    def set_progress_str(self, msg: str) -> None:
        pass

    def error(self, msg: str) -> None:
        pass


class CallbackListener(ProgressListener):
    """Adapter: wrap plain callables."""

    def __init__(self, on_progress=None, on_message=None, on_error=None):
        self._p = on_progress
        self._m = on_message
        self._e = on_error

    def set_progress(self, pct):
        if self._p:
            self._p(pct)

    def set_progress_str(self, msg):
        if self._m:
            self._m(msg)

    def error(self, msg):
        if self._e:
            self._e(msg)


# phase -> progress fraction at completion (decode -> device -> save),
# matching the reference's fixed milestones (simpleprocess.cc:117,294,
# 352,486)
PHASES = (("decode", 0.20), ("develop", 0.75), ("gamut", 0.80),
          ("save", 1.0))


def notify(listener, phase):
    if listener is None:
        return
    for name, pct in PHASES:
        if name == phase:
            listener.set_progress_str(phase)
            listener.set_progress(pct)
            return


# ---------------------------------------------------------------------------
# Auto-value listener surface (reference rtengine.h:334-418: AutoWBListener,
# AutoLogListener, AutoChromaListener, AutoDeconvRadiusListener,
# AutoExpListener::autoMatchedToneCurveChanged, ImageTypeListener,
# HistogramListener :272). The autos run inside plan(); they deposit
# into a thread-local report which process_image forwards to the
# listener after the plan completes — the headless equivalent of the
# coordinator's change callbacks.

import threading

_report = threading.local()


def report_auto(name, value):
    """Called from plan-time auto computations; no-op outside a
    collecting process_image call."""
    d = getattr(_report, "d", None)
    if d is not None:
        d[name] = value


class _Collect:
    def __enter__(self):
        _report.d = {}
        return _report.d

    def __exit__(self, *exc):
        _report.d = None
        return False


class PipelineListener(ProgressListener):
    """Auto-value callbacks; all optional no-ops. Method names follow
    the reference's listener verbs."""

    def image_type_changed(self, is_raw, is_bayer, is_xtrans, is_mono):
        pass

    def auto_wb_changed(self, temp, green):
        pass  # AutoWBListener::WBChanged (ColorTemp -> temp/green)

    def auto_log_changed(self, gain, black_ev, white_ev):
        pass  # AutoLogListener::logEncodingChanged

    def auto_chroma_changed(self, chroma, red, blue):
        pass  # AutoChromaListener::chromaChanged

    def auto_deconv_radius_changed(self, radius):
        pass  # AutoDeconvRadiusListener

    def auto_matched_curve_changed(self, points):
        pass  # AutoExpListener::autoMatchedToneCurveChanged

    def histogram_changed(self, hist_rgbl):
        pass  # HistogramListener::histogramChanged (256-bin R/G/B/L)


def fire_autos(listener, report):
    """Forward a collected auto report to a PipelineListener."""
    if not isinstance(listener, PipelineListener) or not report:
        return
    if "wb" in report:
        listener.auto_wb_changed(*report["wb"])
    if "log" in report:
        listener.auto_log_changed(*report["log"])
    if "chroma" in report:
        listener.auto_chroma_changed(*report["chroma"])
    if "deconv_radius" in report:
        listener.auto_deconv_radius_changed(report["deconv_radius"])
    if "matched_curve" in report:
        listener.auto_matched_curve_changed(report["matched_curve"])


def wants_histogram(listener):
    return (isinstance(listener, PipelineListener)
            and type(listener).histogram_changed
            is not PipelineListener.histogram_changed)
