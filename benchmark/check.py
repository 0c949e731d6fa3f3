"""The comparison that decides a run's `correct`: what the window's chains
produced, judged against the plain reference (benchmark/reference) after
the window has closed.

Numbers compared (each the largest over what is judged; limits in the
configuration's file, `limits`):

* lnp_rel: a recorded lnprob against the reference's at the recorded
  position, over the size of the terms that depend on theta;
* pos_rel: a walker's new position against the reference's proposal;
* flip_rel: the reference's margin |log-ratio - ln U| (over that size)
  at a walker whose move the program decided the other way (a decision
  within rounding of the threshold may differ).

Steps are judged one at a time from the program's own recorded states
(reference/stretch.py:follow): `check_transitions` steps drawn from the
seed over the judged chains, and each chain's first step, from the state
the previous chain ended in.
"""

from __future__ import annotations

import importlib

import torch

from benchmark.reference.stretch import Stream, control_step, follow

#: What `judge` can put in the program's place: the reference in
#: bfloat16 (the lower-precision control), or in float64 with the
#: acceptance's (D - 1) ln z term left out (a planted fault).
STAND_INS = ("bfloat16", "no_lnz")


def blocks_of(n: int, every: int) -> list[int]:
    return [min(every, n - s) for s in range(0, n, every)]


class Reference:
    """The reference's view of a configuration's problem: the posterior
    that the configuration's reference module builds from the problem's
    files (`"reference"`: benchmark/reference/<name>.py, whose
    `build(fitkw, config, device, dtype)` returns it; default "model",
    the single-component fit), with the catalog (`cat`) and the reduction
    (`grid`) it was built from. `config` is the configuration; a Q(T)
    alone (a `partition` entry, which has a `kind`; no configuration has
    one) stands for a configuration of the default reference with that
    partition."""

    def __init__(self, fitkw: dict, config: dict, device):
        if "kind" in config:
            config = {"partition": config}
        self.fitkw, self.config, self.device = fitkw, config, device
        self.build = importlib.import_module(
            f"benchmark.reference.{config.get('reference', 'model')}").build
        self.post = self.build(fitkw, config, device)
        self.cat, self.grid = self.post.cat, self.post.grid
        self._lower = None

    def stand_in(self, kind: str) -> tuple:
        """(posterior, whether the acceptance keeps (D - 1) ln z) of a
        STAND_INS entry."""
        if kind == "bfloat16":
            if self._lower is None:
                self._lower = self.build(self.fitkw, self.config, self.device,
                                         dtype=torch.bfloat16)
            return self._lower, True
        if kind == "no_lnz":
            return self.post, False
        raise ValueError(f"no stand-in {kind!r}: one of {STAND_INS}")


def pick_transitions(records, n: int, rng) -> list:
    """(record, t) pairs: n steps spread over the judged records in turn,
    t drawn uniformly from the steps that have a recorded state before
    them, plus each chain's first step (t = -1)."""
    judged = [r for r in records if r.get("chain") is not None]
    picks = [(r, -1) for r in judged]
    for k in range(n if judged else 0):
        r = judged[k % len(judged)]
        picks.append((r, int(rng.integers(0, r["chain"].shape[1] - 1))))
    return picks


def step_of(rec, t):
    """(x_t, x_t1, lnp_t, lnp_t1, step index) of a record's step t -> t+1."""
    chain, lnps = rec["chain"], rec["lnps"]
    if t < 0:
        return rec["pos0"], chain[:, 0], rec["lnp0"], lnps[:, 0], 0
    return chain[:, t], chain[:, t + 1], lnps[:, t], lnps[:, t + 1], t + 1


def judge(ref: Reference, records: list, traffic: dict, seed_rng, *, a: float,
          stand_in: str | None = None) -> tuple[dict, dict]:
    """(numbers, {request index: its numbers}) of the judged requests, or
    with `stand_in` (a STAND_INS entry) those of that stand-in put in the
    program's place on the same steps; the caller holds them to the
    configuration's limits."""
    numbers = dict(lnp_rel=0.0, pos_rel=0.0, flip_rel=0.0)
    per_request = {}
    post_in, lnz = ref.stand_in(stand_in) if stand_in else (None, True)
    picks = pick_transitions(records, traffic["check_transitions"], seed_rng)
    streams = {r["i"]: Stream(r["seed"], blocks_of(r["nsteps"], r["block"]),
                              r["chain"].shape[0], ref.device)
               for r in records if r.get("chain") is not None}
    wanted = {}
    for rec, t in picks:
        wanted.setdefault(rec["i"], set()).add(step_of(rec, t)[4])
    draws = {i: streams[i].steps(js) for i, js in wanted.items()}
    for rec, t in picks:
        x_t, x_t1, lnp_t, lnp_t1, j = step_of(rec, t)
        rnd = draws[rec["i"]][j]
        if post_in is not None:
            x_t, x_t1, lnp_t, lnp_t1 = control_step(post_in, x_t, rnd, a, lnz=lnz)
        got = follow(ref.post, x_t, x_t1, lnp_t, lnp_t1, rnd, a)
        mine = per_request.setdefault(rec["i"], {})
        for k in numbers:
            mine[k] = max(mine.get(k, 0.0), got[k])
    for mine in per_request.values():
        for k, v in mine.items():
            numbers[k] = max(numbers[k], v)
    return numbers, per_request
