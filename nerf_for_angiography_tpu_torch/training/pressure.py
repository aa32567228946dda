"""Truncation-pressure tuning for the compacted stepper (a copy of
``nerf_for_angiography_tpu/training/pressure.py``, whose docstring keeps the
measurements that forced each rule; only the imports differ).

``choose_compact_mode``'s probe is the single held-out view, while the train
batch importance-samples every view, so the batch can press harder than the
probe says. The tuner grows k / w_cap / k_lo on the batch's own pressure
(train.py::march_pressure), remembers that growth as floors, and lets the
floors decay when the batch stays quiet.

The machine's invariants:

1. any nonzero pressure at an observed boundary forces a re-choose at
   that boundary (unless muted), not at the next cadence check;
2. batch-measured growth persists as floors across probe-driven re-checks;
3. floors decay one bucket per QUIET display window, so a converged or
   pruning grid can still shrink k back down;
4. fires that change nothing back off exponentially (cap: display
   cadence) instead of paying one probe march per chunk forever;
5. a decay that BOUNCES (a fire regrows a floor, or re-collapses the
   just-unbanned bucket split, within one display window of the decay)
   doubles the quiet period required before the next decay, and a decay
   that sticks for a full window resets the backoff;
5b. decays are EVIDENCE-GATED: a floor only sheds its bucket when the last
   two display windows' observed max active counts fit the smaller size.
"""

from __future__ import annotations

import dataclasses

from .train import compact_k_for, compact_k_lo_for

__all__ = ["Tuning", "PressureTuner"]


@dataclasses.dataclass(frozen=True)
class Tuning:
    """One compacted-stepper configuration: the key of the step cache in
    ``training/loop.py``."""

    mode: str | None = None
    k: int = 0
    w_cap: int = 0  # hybrid candidate window (0 = mode has none)
    w_lo: int = 0  # two-bucket lo window (0 = single bucket)
    k_lo: int = 0  # two-bucket lo compaction width (0 = single k)


@dataclasses.dataclass
class PressureTuner:
    """Mutable pressure/floor/mute state threaded through the train loop.

    The loop calls, in boundary order:

    * ``observe(m, over, over_k_lo, edge, ac, ac_lo)`` after each compacted
      chunk with the chunk's max of the batch's ``march_pressure`` scalars
      (the port observes each chunk at its own boundary);
    * ``engage(choice, cfg)`` when the compacted stepper first switches on;
    * ``retune(tuning, choice, cfg)`` at cadence checks and on fires;
    * ``resolve(m, changed, recheck)`` after a FIRED re-choose, with
      whether it changed anything;
    * ``decay_if_quiet(m)`` at display boundaries while compacted.
    """

    display_every: int
    # batch-measured need from the last observed chunk (march_pressure)
    over: int = 0
    over_lo: int = 0
    edge: int = 0
    fire: bool = False
    mute_until: int = -1
    muted_streak: int = 0  # consecutive no-change fires (mute backoff)
    fired: int = 0  # fires that grew the stepper (TrainResult.timing)
    muted: int = 0  # fires that could not grow and stood down
    # persistent batch-measured floors (invariant 2) + their decay gate
    k_floor: int = 0
    klo_floor: int = 0
    wcap_floor: int = 0
    last_seen: int = -(10**9)  # last boundary with nonzero pressure
    # the bucket split collapsed under pressure/floors (lo-bucket need
    # reached k): the next probe-blind re-check would re-enable it from
    # the probe's small width_lo and the batch would truncate again —
    # measured as a k_lo 40↔0 flip at EVERY 100-iter check for a whole
    # 20k run (r3q12_h2k_s0, 179 retunes, half the run truncating).
    # While banned, retunes force k_lo = 0; a quiet display window lifts
    # the ban like the floors decay.
    klo_banned: bool = False
    # floor-decay backoff (invariant 5): boundary of the last decay, the
    # floors/ban snapshot it left behind, and the consecutive-bounce streak
    # that scales the quiet period required for the next decay
    last_decay: int = -(10**9)
    decay_streak: int = 0
    decay_bounces: int = 0  # lifetime count (TrainResult.timing / stats)
    _decay_snapshot: tuple = (0, 0, 0, True)
    # evidence gate for the decay (invariant 5b): the batch's observed max
    # active counts, tracked per display window with one window of memory
    # (current + previous) — a floor never decays below what the batch
    # measurably used, so a decay can only fire when shrinking provably
    # won't truncate. Without this the flagship's quiet-but-loaded steady
    # state still bounced 3 times per 20k run under the pure exponential
    # backoff (r4q1 conf_s1).
    ac_window: int = 0
    ac_prev: int = 0
    aclo_window: int = 0
    aclo_prev: int = 0

    # -- boundary observation ------------------------------------------------
    def observe(
        self,
        m: int,
        over: int,
        over_lo: int,
        edge: int,
        ac: int = 0,
        ac_lo: int = 0,
    ) -> None:
        """Record the batch's pressure scalars for boundary ``m`` and arm a
        fire unless muted. Zeros overwrite stale values — the scalars are
        only consumed by a fire, never across boundaries. ``ac``/``ac_lo``
        (max per-ray active counts, march_pressure) accumulate as the
        decay's evidence window."""
        self.over, self.over_lo, self.edge = over, over_lo, edge
        self.ac_window = max(self.ac_window, ac)
        self.aclo_window = max(self.aclo_window, ac_lo)
        if over > 0 or over_lo > 0 or edge > 0:
            self.last_seen = m  # holds the floors up (decay gate)
            if m > self.mute_until:
                self.fire = True

    # -- sizing --------------------------------------------------------------
    def engage(self, choice, cfg) -> Tuning:
        """Initial compacted-stepper sizing from a ``CompactChoice``,
        floored by any pressure history (floors survive a revert-to-dense
        and re-engage)."""
        k = max(compact_k_for(choice.width, cfg), self.k_floor)
        w_cap = choice.w_cap
        if w_cap and self.wcap_floor:
            w_cap = max(w_cap, min(self.wcap_floor, cfg.depth_samples_per_ray))
        k_lo = (
            compact_k_lo_for(choice.width_lo, k, cfg)
            if choice.w_lo and not self.klo_banned
            else 0
        )
        return Tuning(choice.mode, k, w_cap, choice.w_lo, k_lo)

    def retune(self, t: Tuning, choice, cfg) -> Tuning:
        """Re-size an engaged stepper against a fresh probe ``choice``.

        Same-mode proposals GROW freely (losslessness forces it) but SHRINK
        only past a 32-wide hysteresis band — small shrinks would thrash
        compiles for marginal MLP time, while ladder descents (interim k →
        budget k) and real grid convergence pay for themselves. A fire
        additionally grows by the batch's own measured need and REMEMBERS
        it as a floor; floors apply to EVERY retune, fired or not."""
        fire = self.fire and choice.mode == t.mode
        mode2 = choice.mode

        # ---- k: probe -> hysteresis -> batch pressure -> floor.
        # k settles FIRST: every k_lo decision below compares against the
        # k actually being paid. (The first wiring compared k_lo to the
        # pre-floor probe k — on a floored run, k_lo >= probe-k collapsed
        # the split on exactly the alternating checks where hysteresis had
        # state to compare, re-enabled it on the others: a 48<->0 flip at
        # EVERY check, r3q12_h2k_s1.)
        k2 = compact_k_for(choice.width, cfg)
        if mode2 == t.mode and k2 > t.k - 32:
            k2 = max(k2, t.k)
        if fire and self.over > 0:
            # the BATCH measured its own need this chunk — floor the
            # probe-derived size with it (the probe is the test view; the
            # train batch can press harder) and REMEMBER the floor
            k2 = max(k2, compact_k_for(t.k + self.over, cfg))
            self.k_floor = max(self.k_floor, k2)
        if self.k_floor:
            k2 = max(k2, self.k_floor)

        # ---- w_cap: same ladder.
        wcap2 = choice.w_cap
        if mode2 == t.mode and wcap2 > t.w_cap - 32:
            wcap2 = max(wcap2, t.w_cap)
        if fire and self.edge > 0 and t.w_cap:
            wcap2 = max(wcap2, min(t.w_cap + 16, cfg.depth_samples_per_ray))
            self.wcap_floor = max(self.wcap_floor, wcap2)
        if self.wcap_floor and wcap2:
            wcap2 = max(wcap2, min(self.wcap_floor, cfg.depth_samples_per_ray))

        # ---- w_lo: hysteresis only (sized by the chooser's quantile).
        wlo2 = choice.w_lo
        if mode2 == t.mode and wlo2 and t.w_lo and wlo2 > t.w_lo - 32:
            wlo2 = max(wlo2, t.w_lo)

        # ---- k_lo, against the FINAL k2. A collapse (need reached k: the
        # split buys nothing; k_lo = 0 marches every ray at k) must NOT
        # keep the stale truncating k_lo, and must ban re-enablement until
        # a quiet window (see klo_banned).
        klo2 = (
            compact_k_lo_for(choice.width_lo, k2, cfg)
            if wlo2 and not self.klo_banned
            else 0
        )
        if mode2 == t.mode and klo2 and t.k_lo and klo2 > t.k_lo - 32:
            klo2 = max(klo2, t.k_lo)
            if klo2 >= k2:
                klo2 = 0
                self.klo_banned = True
        if fire and self.over_lo > 0 and klo2:
            klo2 = compact_k_lo_for(t.k_lo + self.over_lo, k2, cfg)
            klo2 = max(klo2, t.k_lo) if klo2 else 0
            if klo2 >= k2:
                klo2 = 0
            if klo2:
                self.klo_floor = max(self.klo_floor, klo2)
            else:
                self.klo_banned = True  # need reached k: ban the split
        if self.klo_floor and klo2:
            klo2 = max(klo2, self.klo_floor)
            if klo2 >= k2:
                klo2 = 0
                self.klo_banned = True  # floored need reached k: ban
        return Tuning(mode2, k2, wcap2, wlo2, klo2)

    # -- fire bookkeeping ------------------------------------------------------
    def resolve(self, m: int, changed: bool, recheck: int) -> None:
        """Close out a fired re-choose at boundary ``m``. ``changed`` is
        whether the re-choose altered the running stepper (a revert to the
        dense stepper counts as changed). No-change fires stand down with
        exponential backoff — re-probing every chunk would cost more than
        it saves — capped at display cadence (invariant 4)."""
        if not self.fire:
            return
        if not changed:
            self.muted += 1
            self.muted_streak += 1
            self.mute_until = m + min(
                self.display_every,
                recheck * (2 ** min(self.muted_streak, 4)),
            )
        else:
            self.fired += 1
            self.muted_streak = 0
        # decay bounce (invariant 5): this fire regrew a floor — or
        # re-collapsed the just-unbanned split — within one display window
        # of the last decay. The decay was premature: double the quiet
        # period the next one requires. Counted once per decay (the
        # sentinel reset), and checked regardless of ``changed`` — a floor
        # can regrow before the shrink it licenses ever compiles.
        if m - self.last_decay <= self.display_every:
            kf, wf, lf, banned = self._decay_snapshot
            regrown = (
                self.k_floor > kf
                or self.wcap_floor > wf
                or self.klo_floor > lf
                or (self.klo_banned and not banned)
            )
            if regrown:
                self.decay_streak = min(self.decay_streak + 1, 4)
                self.decay_bounces += 1
                self.last_decay = -(10**9)
        self.fire = False
        self.over = self.over_lo = self.edge = 0

    # -- floor decay -----------------------------------------------------------
    def decay_if_quiet(self, m: int) -> None:
        """A QUIET display window (no pressure observed anywhere in it)
        decays each floor one bucket: a converged/pruning grid must be
        allowed to shrink k back down, and a too-eager decay only costs a
        few truncating chunks before the floor re-grows (invariant 3).
        Bounced decays back off exponentially (invariant 5) so the
        steady state cannot oscillate decay->regrow every window.
        Call at display boundaries while the compacted stepper runs."""
        if (
            self.decay_streak
            and self.last_decay > -(10**8)
            and m - self.last_decay >= self.display_every
        ):
            # the last decay survived a full display window un-bounced:
            # the grid really did shrink — drop the backoff
            self.decay_streak = 0
        if m - self.last_seen >= self.display_every * (2**self.decay_streak):
            # evidence gate (invariant 5b): a floor only sheds its bucket
            # when the batch's own observed max active count over the last
            # two display windows fits the SMALLER size — shedding what the
            # batch measurably uses guarantees a bounce. All-or-nothing per
            # bucket so floors stay on their 32-ladder (arbitrary values
            # would mint new compiled stepper tunings).
            ev_k = max(self.ac_window, self.ac_prev)
            ev_klo = max(self.aclo_window, self.aclo_prev)
            before = (self.k_floor, self.wcap_floor, self.klo_floor,
                      self.klo_banned)
            if ev_k <= self.k_floor - 32:
                self.k_floor = max(0, self.k_floor - 32)
            self.wcap_floor = max(0, self.wcap_floor - 16)
            if ev_klo <= self.klo_floor - 32:
                self.klo_floor = max(0, self.klo_floor - 32)
            self.klo_banned = False  # quiet window: let the split retry
            after = (self.k_floor, self.wcap_floor, self.klo_floor,
                     self.klo_banned)
            # a no-op decay (nothing shed) must not arm bounce detection —
            # a later fresh fire is growth, not a bounce
            if after != before:
                self.last_decay = m
                self._decay_snapshot = after
        # the evidence window shifts at every display boundary (the caller
        # invokes this once per boundary while compacted)
        self.ac_prev, self.ac_window = self.ac_window, 0
        self.aclo_prev, self.aclo_window = self.aclo_window, 0
