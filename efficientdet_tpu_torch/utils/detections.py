"""One image's detections held against another's, where near-tied scores may swap."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def detection_mismatch(got: Sequence[np.ndarray], want: Sequence[np.ndarray], box_px: float,
                       score_atol: float, score_rtol: float = 0.0) -> Optional[str]:
    """``got`` against ``want``, each one image's (boxes (N, 4), scores (N,),
    classes (N,)) sorted by score: the same count, above 0; scores within
    ``score_atol`` + ``score_rtol`` |want| place by place; boxes within
    ``box_px`` and classes exact, in the same order but for runs of
    detections whose scores lie within that tolerance of their
    neighbour's, which may come in either order (float32 sums in another
    order swap near-ties: at D7 4 of 100 detections did), matched one to
    one within the run. Returns the first disagreement, or None."""
    (gb, gs, gc), (wb, ws, wc) = [[np.asarray(t) for t in d] for d in (got, want)]
    n = len(ws)
    if len(gs) != n or n == 0:
        return f"counts {len(gs)} and {n}"
    tol = score_atol + score_rtol * np.abs(ws)
    over = np.abs(gs - ws) - tol
    if (over > 0).any():
        i = int(over.argmax())
        return f"score {i}: {gs[i]} against {ws[i]}"
    start = 0
    while start < n:
        stop = start + 1
        while stop < n and ws[stop - 1] - ws[stop] <= tol[stop - 1] + tol[stop]:
            stop += 1
        free = list(range(start, stop))
        for g in range(start, stop):
            hit = next((w for w in free if gc[g] == wc[w] and np.abs(gb[g] - wb[w]).max() <= box_px),
                       None)
            if hit is None:
                return (f"detection {g} (class {gc[g]}, score {gs[g]}, box {gb[g]}) has no match "
                        f"among {start}..{stop - 1}")
            free.remove(hit)
        start = stop
    return None
