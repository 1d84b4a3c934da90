"""Structured per-stage timing and optional JAX profiler traces.

The reference's only observability is a rich Live step table with check-marks
(``msm_we.py:529-586``) and ad-hoc ``time.perf_counter`` calls. Here every
pipeline stage records wall-clock into a structured report and a
``stage:<name>`` span in the JAX profiler's trace, a profiler context can wrap
any stage with a TensorBoard-compatible JAX trace, and
:func:`device_activity_by_stage` reduces such a trace to the device work each
stage ran.
"""
from __future__ import annotations

import contextlib
import json
import time

from ._logging import log

__all__ = [
    "StageTimer",
    "profile_trace",
    "live_stage_display",
    "device_activity_by_stage",
]

STAGE_SPAN_PREFIX = "stage:"


class StageTimer:
    """Collects named stage durations; renderable as text or JSON.

    An optional ``on_change`` callback fires whenever a stage starts,
    finishes, or gains a note -- the hook :func:`live_stage_display` uses to
    refresh its table.
    """

    def __init__(self, on_change=None):
        self.stages = []  # list of (name, seconds, note)
        self.failed = set()  # indices of stages that raised
        self.running = None  # index of the innermost currently running stage
        self._stack = []  # indices of nested running stages
        self._on_change = on_change

    def _notify(self):
        if self._on_change is not None:
            try:
                self._on_change()
            except Exception:  # display failures must never kill the build
                pass

    @contextlib.contextmanager
    def stage(self, name, note=""):
        # Append at entry so set_note() inside the block targets this stage.
        # Running stages form a STACK: after a nested stage exits, notes and
        # the live display's running marker return to the enclosing stage
        # (with a flat `running = None` reset, the outer stage would render
        # finished while still executing)
        self.stages.append((name, 0.0, note))
        idx = len(self.stages) - 1
        if not hasattr(self, "_stack"):  # unpickled older timers
            self._stack = []
        self._stack.append(idx)
        self.running = idx
        self._notify()
        from jax.profiler import TraceAnnotation

        t0 = time.perf_counter()
        try:
            with TraceAnnotation(STAGE_SPAN_PREFIX + name):
                yield self
        except BaseException:
            self.failed.add(idx)
            raise
        finally:
            elapsed = time.perf_counter() - t0
            n, _, note_now = self.stages[idx]
            self.stages[idx] = (n, elapsed, note_now)
            self._stack.pop()
            self.running = self._stack[-1] if self._stack else None
            self._notify()
            log.info(f"[stage] {name}: {elapsed:.3f}s {note_now}")

    def set_note(self, note):
        if self.stages:
            idx = self.running if self.running is not None else len(self.stages) - 1
            name, elapsed, _ = self.stages[idx]
            self.stages[idx] = (name, elapsed, note)
            self._notify()

    def __getstate__(self):
        # The change callback may close over a live terminal display;
        # pickles and the mid-build validation-model deepcopy must not
        # carry it
        state = self.__dict__.copy()
        state["_on_change"] = None
        return state

    @property
    def total(self):
        return sum(s[1] for s in self.stages)

    def as_dict(self):
        return {
            "stages": [
                {"name": n, "seconds": round(s, 4), "note": note}
                for n, s, note in self.stages
            ],
            "total_seconds": round(self.total, 4),
        }

    def report(self):
        lines = ["haMSM build timing:"]
        for name, seconds, note in self.stages:
            lines.append(f"  {name:<32s} {seconds:8.3f}s  {note}")
        lines.append(f"  {'TOTAL':<32s} {self.total:8.3f}s")
        return "\n".join(lines)

    def to_json(self, path):
        with open(path, "w") as fp:
            json.dump(self.as_dict(), fp, indent=2)


@contextlib.contextmanager
def live_stage_display(timer, enabled=True):
    """Rich ``Live`` pipeline-step table driven by a :class:`StageTimer`.

    The equivalent of the reference's step table
    (``msm_we.py:529-586``): one row per stage with a running/check/cross
    marker, elapsed seconds, and the stage note, refreshed as stages progress.
    Degrades to a no-op when ``enabled`` is False or rich is unavailable, so
    ``build_analyze_model(show_live_display=...)`` is safe everywhere
    (including headless CI).
    """
    if not enabled:
        yield None
        return
    try:
        from rich.live import Live
        from rich.table import Table
    except Exception:  # pragma: no cover - rich is an optional nicety
        log.debug("rich unavailable; live display disabled")
        yield None
        return

    def render():
        table = Table(title="haMSM build")
        table.add_column("")
        table.add_column("Step")
        table.add_column("Time", justify="right")
        table.add_column("Note")
        stack = getattr(timer, "_stack", [])
        for idx, (name, seconds, note) in enumerate(timer.stages):
            # Every stage on the stack is still executing, not just the
            # innermost one -- an enclosing stage must not render finished
            # while a nested stage runs
            in_progress = idx == timer.running or idx in stack
            if idx in timer.failed:
                mark = "[red]x[/]"
            elif in_progress:
                mark = "[yellow]>[/]"
            else:
                mark = "[green]OK[/]"
            shown = f"{seconds:.2f}s" if (seconds or not in_progress) else "..."
            table.add_row(mark, name, shown, str(note))
        return table

    with Live(render(), refresh_per_second=4, transient=False) as live:
        prev = timer._on_change
        timer._on_change = lambda: live.update(render())
        try:
            yield live
        finally:
            live.update(render())
            timer._on_change = prev


@contextlib.contextmanager
def profile_trace(log_dir=None):
    """Optionally wrap a block in a JAX profiler trace (TensorBoard format).

    No-op when ``log_dir`` is None, so callers can pass a config value
    straight through.
    """
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info(f"JAX profiler trace written to {log_dir}")


def device_activity_by_stage(xplane_path):
    """Device work per build stage, from a JAX profiler trace.

    Reads the ``.xplane.pb`` that a trace of a build writes (``profile_dir``
    of ``build_analyze_model``, or ``jax.profiler.trace``), finds the
    ``stage:<name>`` spans :class:`StageTimer` records on the host, and
    assigns each device operation (an event carrying an ``hlo_module``
    stat, on the ``/device:`` planes when the trace has any, else on the
    host planes of the CPU backend) to the stage whose span contains its
    start. Returns ``{stage: {"busy_s", "n_ops", "modules"}}``: the union
    of the operations' intervals in seconds, their count, and the sorted
    names of the XLA modules they belong to. Stages without device work
    map to zeros.
    """
    from jax.profiler import ProfileData

    data = ProfileData.from_file(str(xplane_path))
    spans = []
    ops = {"device": [], "host": []}
    for plane in data.planes:
        where = "device" if plane.name.startswith("/device:") else "host"
        for line in plane.lines:
            for ev in line.events:
                if ev.name.startswith(STAGE_SPAN_PREFIX):
                    spans.append((
                        ev.name[len(STAGE_SPAN_PREFIX):],
                        ev.start_ns, ev.start_ns + ev.duration_ns,
                    ))
                    continue
                module = next(
                    (v for k, v in ev.stats if k == "hlo_module"), None
                )
                if module is not None:
                    ops[where].append(
                        (ev.start_ns, ev.start_ns + ev.duration_ns, module)
                    )
    ops = ops["device"] or ops["host"]
    out = {}
    for name, lo, hi in spans:
        inside = sorted((s, e, m) for s, e, m in ops if lo <= s < hi)
        busy, end = 0.0, None
        for s, e, _m in inside:
            if end is None or s >= end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        entry = out.setdefault(name, {"busy_s": 0.0, "n_ops": 0, "modules": []})
        entry["busy_s"] += busy * 1e-9
        entry["n_ops"] += len(inside)
        entry["modules"] = sorted(set(entry["modules"]) | {m for *_x, m in inside})
    return out
