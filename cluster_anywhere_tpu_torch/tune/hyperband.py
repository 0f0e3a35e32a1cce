"""Synchronous HyperBand (+ the BOHB coupling variant).

Reference parity: ``python/ray/tune/schedulers/hyperband.py``
(HyperBandScheduler) and ``hb_bohb.py`` (HyperBandForBOHB).  Unlike ASHA
(schedulers.AsyncHyperBandScheduler), synchronous HyperBand holds a rung
until its whole cohort reports, then promotes exactly the top 1/eta — no
promotion-on-partial-information.  That needs a PAUSE decision: a trial
reaching its rung budget checkpoints and releases its resources while the
rest of the cohort catches up; the controller resumes promoted trials from
their checkpoints.

Bracket arithmetic follows the HyperBand paper (Li et al., 2018): with
s_max = floor(log_eta(max_t)), bracket s starts
n_s = ceil((s_max + 1) / (s + 1) * eta^s) trials at budget
r_s = max_t * eta^(-s), halving (eta-ing) n and multiplying r by eta each
rung.  Trials are dealt to the bracket with capacity, round-robin from the
most exploratory (s_max) down.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from .schedulers import CONTINUE, STOP, TrialScheduler

PAUSE = "PAUSE"


class HyperBandScheduler(TrialScheduler):
    """Synchronous HyperBand over PAUSE-capable trials."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        max_t: int = 81,
        reduction_factor: float = 3,
    ):
        self.time_attr = time_attr
        self.max_t = int(max_t)
        self.eta = float(reduction_factor)
        self.s_max = int(math.floor(math.log(self.max_t, self.eta)))
        # brackets[s]: {"n0": start cohort size, "rungs": [...]}.  A rung:
        # {"budget": int, "capacity": int, "members": {tid: metric|None},
        #  "promoted": bool}
        self.brackets: List[Dict[str, Any]] = []
        for s in range(self.s_max, -1, -1):
            n0 = int(math.ceil((self.s_max + 1) / (s + 1) * self.eta**s))
            r0 = self.max_t * self.eta ** (-s)
            rungs = []
            n, r = n0, r0
            for k in range(s + 1):
                rungs.append(
                    {
                        "budget": max(1, int(round(r))),
                        "capacity": max(1, int(n)),
                        "members": {},
                        "promoted": False,
                    }
                )
                n = int(math.floor(n / self.eta))
                r = r * self.eta
            self.brackets.append({"n0": n0, "rungs": rungs})
        # trial id -> (bracket index, rung index)
        self.position: Dict[str, tuple] = {}
        self._resume_queue: List[tuple] = []  # (trial_id, next budget)
        self._stop_queue: List[str] = []  # paused trials that lost their rung

    # ------------------------------------------------------------- placement

    def _place(self, trial) -> tuple:
        tid = trial.trial_id
        if tid in self.position:
            return self.position[tid]
        for bi, b in enumerate(self.brackets):
            rung0 = b["rungs"][0]
            if len(rung0["members"]) < rung0["capacity"]:
                rung0["members"][tid] = None
                self.position[tid] = (bi, 0)
                return self.position[tid]
        # all brackets full: recycle the arithmetic of the most exploratory
        # bracket with a fresh cohort (reference: new band iteration)
        b = {
            "n0": self.brackets[0]["n0"],
            "rungs": [
                {
                    "budget": r["budget"],
                    "capacity": r["capacity"],
                    "members": {},
                    "promoted": False,
                }
                for r in self.brackets[0]["rungs"]
            ],
        }
        self.brackets.append(b)
        b["rungs"][0]["members"][trial.trial_id] = None
        self.position[tid] = (len(self.brackets) - 1, 0)
        return self.position[tid]

    # --------------------------------------------------------------- results

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        bi, ri = self._place(trial)
        bracket = self.brackets[bi]
        rung = bracket["rungs"][ri]
        t = result.get(self.time_attr, 0)
        if t < rung["budget"]:
            return CONTINUE
        metric = result.get(self.metric)
        if metric is None:
            return CONTINUE
        val = float(metric) if self.mode == "max" else -float(metric)
        rung["members"][trial.trial_id] = val
        if ri == len(bracket["rungs"]) - 1:
            return STOP  # final rung complete: trial ran its full budget
        self._maybe_promote(bi, ri)
        if rung["promoted"] and self.position.get(trial.trial_id) == (bi, ri):
            return STOP  # cohort judged (error-shrunk capacity): not promoted
        return PAUSE

    def _maybe_promote(self, bi: int, ri: int):
        bracket = self.brackets[bi]
        if ri >= len(bracket["rungs"]) - 1:
            return  # final rung: trials STOP there, nothing to promote into
        rung = bracket["rungs"][ri]
        if rung["promoted"]:
            return
        done = [v for v in rung["members"].values() if v is not None]
        if len(done) < rung["capacity"]:
            return  # cohort still running: synchronous barrier
        nxt = bracket["rungs"][ri + 1]
        k = nxt["capacity"]
        ranked = sorted(
            ((v, tid) for tid, v in rung["members"].items() if v is not None),
            reverse=True,
        )
        promoted = [tid for _, tid in ranked[:k]]
        rung["promoted"] = True
        for tid in promoted:
            nxt["members"][tid] = None
            self.position[tid] = (bi, ri + 1)
            self._resume_queue.append((tid, nxt["budget"]))
        # non-promoted cohort members are done: their pause becomes a stop
        self._stop_queue.extend(tid for _, tid in ranked[k:])

    def trials_to_resume(self) -> List[tuple]:
        """Controller hook: drain (trial_id, next_budget) promotions."""
        out, self._resume_queue = self._resume_queue, []
        return out

    def trials_to_stop(self) -> List[str]:
        """Controller hook: drain paused trials whose rung judged them out."""
        out, self._stop_queue = self._stop_queue, []
        return out

    def on_no_more_trials(self):
        """Controller hook when the searcher is exhausted: cohorts that can
        never fill shrink to their actual membership so partial brackets
        still promote instead of waiting forever."""
        for bi, bracket in enumerate(self.brackets):
            for ri, rung in enumerate(bracket["rungs"]):
                if rung["members"] and len(rung["members"]) < rung["capacity"]:
                    rung["capacity"] = len(rung["members"])
                    self._maybe_promote(bi, ri)

    def on_trial_complete(self, trial, result: Optional[Dict[str, Any]]):
        # a trial that errored out of its rung must not block the cohort
        pos = self.position.get(trial.trial_id)
        if pos is None:
            return
        bi, ri = pos
        rung = self.brackets[bi]["rungs"][ri]
        if rung["members"].get(trial.trial_id) is None and trial.trial_id in rung["members"]:
            if result and self.metric in result:
                v = float(result[self.metric])
                rung["members"][trial.trial_id] = v if self.mode == "max" else -v
            else:
                # no score to rank: drop it from the cohort entirely — a
                # lingering None member would keep done < capacity forever
                # (capacity shrink alone can't fix a partially-filled rung)
                del rung["members"][trial.trial_id]
                rung["capacity"] = max(1, rung["capacity"] - 1)
        self._maybe_promote(bi, ri)


class HyperBandForBOHB(HyperBandScheduler):
    """HyperBand whose rung completions feed the BOHB searcher's per-budget
    model (reference: hb_bohb.py).  The searcher (tune/bohb.TuneBOHB) is
    informed via `on_rung_result(budget, config, metric)` so its KDE for
    that budget reflects the full cohort before the next suggestion."""

    def __init__(self, *args, searcher=None, **kw):
        super().__init__(*args, **kw)
        self._searcher = searcher

    def attach_searcher(self, searcher):
        if self._searcher is None:  # an explicitly-passed searcher wins
            self._searcher = searcher

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        # capture the rung the result is evaluated in BEFORE super() runs:
        # if this is the cohort-closing report and the trial is promoted,
        # its position advances to the next rung — recording the metric
        # under that bigger budget would pollute exactly the observations
        # BOHB's per-budget model needs most (the top-k configs)
        bi, ri = self._place(trial)
        budget = self.brackets[bi]["rungs"][ri]["budget"]
        decision = super().on_trial_result(trial, result)
        if (
            decision in (PAUSE, STOP)
            and self._searcher is not None
            and hasattr(self._searcher, "on_rung_result")
            and self.metric in result
        ):
            self._searcher.on_rung_result(
                budget, dict(trial.config), float(result[self.metric])
            )
        return decision
