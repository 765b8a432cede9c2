"""The program's spans of the traced slice, for the readers that read
them: `ieee80211_tpu_torch.utils.metrics.SPANS`, which holds the spans of
the latest stretch of public calls run under torch.profiler (the traced
calls). A program without the recorder gives none, and its readers return
None."""
from __future__ import annotations

from typing import Iterable, List, Optional


def recorded() -> Optional[list]:
    """Every span of the slice, or None where the program records none."""
    try:
        from ieee80211_tpu_torch.utils import metrics
    except ImportError:
        return None
    store = getattr(metrics, "SPANS", None)
    spans = list(store) if store is not None else []
    return spans or None


def named(spans: Iterable, names) -> List:
    names = {names} if isinstance(names, str) else set(names)
    return [s for s in spans if s.name in names]


def total_s(spans: Iterable) -> float:
    """Summed durations, in seconds."""
    return sum(s.end - s.start for s in spans) * 1e-9


def self_s(spans: list, names, thread_of: str) -> Optional[float]:
    """Summed self time (duration less that of child spans), in seconds,
    of the spans named `names` on the threads of the `thread_of` spans;
    None if there are none."""
    tids = {s.tid for s in spans if s.name == thread_of}
    mine = [s for s in named(spans, names) if s.tid in tids]
    if not mine:
        return None
    kids = {}
    for s in spans:
        kids[s.parent] = kids.get(s.parent, 0) + (s.end - s.start)
    return sum(s.end - s.start - kids.get(s.span_id, 0)
               for s in mine) * 1e-9


def counts(ctx: dict) -> dict:
    return ctx.get("counts") or {}


def window_s(ctx: dict) -> Optional[float]:
    tr = ctx.get("trace")
    w = getattr(tr, "window_s", None)
    return w if w else None
