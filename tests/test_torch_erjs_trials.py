"""Port parity: the eRJS trials (K2's plain version) on hand-made walkers.

K2 and K4's rejection regime (``csrc/erjs.cuh``) make a walker's first
round of trials on its own lane and its later rounds on the whole warp,
32 trials a pass; whatever the order, the walker takes its lowest
accepting trial.  The walker sets of ``_torch_port.erjs_walkers`` are
chosen with the port's plain ``erjs_step`` so that first accepts fall at
the first trial, at the round boundary (trials - 1, trials), at 31 and
32, at the first pass's boundary (trials + 31, trials + 32) and at the
last trial of the budget; beside them walkers that fall back, walkers on
a row of zero weights and infeasible ones (no edges, bound 0).  Here the
port's plain ``erjs_step`` is held against the reference's
``repro.core.erjs.erjs_step`` on them, under every device rule and
(trials, rounds) of ``ERJS_BUDGETS``: next node and fallback bit for
bit, and the rounds the reference ran equal to the most any walker's
proposals needed.  ``test_torch_erjs_card.py`` holds the kernels against
this plain version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (ERJS_BUDGETS, ERJS_PROGRAMS,  # noqa: F401
                         erjs_first_accepts, erjs_walkers, one_torch_thread)
from repro.core.erjs import erjs_step as ref_erjs_step
from repro.graphs.csr import CSRGraph as RefGraph
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.core.erjs import erjs_step
from repro_torch.walks import make_workload

BUDGET_IDS = [f"{k}x{r}" for k, r in ERJS_BUDGETS]


def test_first_accepts_cover_the_boundaries():
    assert erjs_first_accepts(8, 16) == [0, 7, 8, 31, 32, 39, 40, 127]
    assert erjs_first_accepts(40, 2) == [0, 31, 32, 39, 40, 71, 72, 79]
    assert erjs_first_accepts(1, 1) == [0]


@pytest.mark.parametrize("trials,rounds", ERJS_BUDGETS, ids=BUDGET_IDS)
@pytest.mark.parametrize("name", ERJS_PROGRAMS)
def test_plain_erjs_matches_reference(name, trials, rounds):
    s = erjs_walkers(name, trials, rounds)
    budget = trials * rounds
    kind = s["kind"]
    for what in ("fallback", "zero_row", "no_edges", "bound_0"):
        assert (kind == what).any(), f"no {what} walker"
    pw = make_workload(name)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    nxt, fb, used = erjs_step(
        interop.graph_from_arrays(*s["arrays"]), pw, pw.params(),
        t(s["cur"]), t(s["prev"]), t(s["step"]),
        interop.keys_from_arrays(s["kd"]), torch.from_numpy(s["bound"]),
        trials, rounds, wstate=interop.wstate_from_arrays(s["ws"]))
    used = used.numpy()
    # the set holds every boundary, and the proposals it was built for
    assert np.array_equal(used, s["used"])
    accepted = ~fb.numpy() & (nxt.numpy() >= 0)
    assert set(erjs_first_accepts(trials, rounds)) <= set(
        (used[accepted] - 1).tolist())
    assert (used[fb.numpy()] == budget).all()
    assert (used[np.isin(kind, ("no_edges", "bound_0"))] == 0).all()
    assert fb.numpy()[kind == "zero_row"].all()

    wl = ref_make_workload(name)
    indptr, indices, h, labels = s["arrays"]
    ref_g = RefGraph(indptr=jnp.asarray(indptr), indices=jnp.asarray(indices),
                     h=jnp.asarray(h), labels=jnp.asarray(labels))
    j = lambda a: jnp.asarray(a, jnp.int32)
    want_n, want_fb, want_r = ref_erjs_step(
        ref_g, wl, wl.params(), j(s["cur"]), j(s["prev"]), j(s["step"]),
        jax.random.wrap_key_data(jnp.asarray(s["kd"])),
        jnp.asarray(s["bound"]), trials_per_round=trials, max_rounds=rounds,
        wstate=None if s["ws"] is None else jnp.asarray(s["ws"]))
    assert np.array_equal(np.asarray(want_n), nxt.numpy())
    assert np.array_equal(np.asarray(want_fb), fb.numpy())
    # the reference returns the rounds it ran: the most any walker needed
    assert int(want_r) == int(np.ceil(used / trials).max())
